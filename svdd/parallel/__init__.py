"""Device-mesh parallelism: DDP/FSDP/TP equivalents via jax.sharding."""

from svdd.parallel import mesh  # noqa: F401
