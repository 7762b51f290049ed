"""The evaluation harness: benchmark loaders, metrics, the harness and the
model adapters (port of leopard_tpu/evaluation)."""
