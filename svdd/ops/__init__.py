"""Compute ops: plain-JAX counterparts of the reference's native
(CUDA/Triton) dependencies, left to XLA.

Mapping (SURVEY.md §2.1):
  flash-attn CUDA        -> ops.attention (XLA dot-product attention)
  mamba-ssm CUDA         -> models.dimamba (associative selective scan)
  Triton layer/RMS norm  -> ops.norms (add + RMSNorm)
  TorchScript fused ops  -> plain jnp (XLA fuses automatically)
"""
