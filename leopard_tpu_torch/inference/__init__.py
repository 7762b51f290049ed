"""Generation: sampling and the bucketed prefill/decode engine."""
