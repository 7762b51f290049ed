"""Plain tensor ops and the Hopper kernels behind them."""
