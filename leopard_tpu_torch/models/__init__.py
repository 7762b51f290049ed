"""Model modules (nn.Module), named after the JAX parameter tree."""
