"""Configuration: re-exported from the JAX package, whose config module
imports no JAX, so that both packages read one source of truth."""

from leopard_tpu.config import *  # noqa: F401,F403
