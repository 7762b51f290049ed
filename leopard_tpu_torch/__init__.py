"""leopard_tpu_torch: the PyTorch and CUDA port of leopard-tpu for NVIDIA
Hopper (H100). The JAX package `leopard_tpu` stays the reference that every
module here is held against; this package imports torch and never JAX."""

__version__ = "0.1.0"
