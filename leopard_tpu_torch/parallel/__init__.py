"""Multi-device parallelism: the process group, the device mesh, the
sharding rules, tensor parallelism and ring context parallelism (port of
leopard_tpu/parallel/)."""
