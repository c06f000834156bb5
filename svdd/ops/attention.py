"""Multi-head attention for the DiT/AR backbones.

Replaces flash-attn's CUDA varlen kernel (reference models/dit.py:4-5,
272-273) with XLA dot-product attention (``mha``) and its
sequence-parallel form (``sp_mha``). The (B, H, L, L) logits are
materialized in f32; at the bio workloads (L=200 DNA / L=50 RNA) they
are small.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def mha(q: Array, k: Array, v: Array, causal: bool = False) -> Array:
  """(B, L, H, D) attention via XLA einsums; fp32 softmax accumulators."""
  d = q.shape[-1]
  logits = jnp.einsum('blhd,bmhd->bhlm', q, k,
                      preferred_element_type=jnp.float32)
  logits = logits / math.sqrt(d)
  if causal:
    l, m = logits.shape[-2:]
    mask = jnp.tril(jnp.ones((l, m), dtype=bool))
    logits = jnp.where(mask, logits, -jnp.inf)
  probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
  return jnp.einsum('bhlm,bmhd->blhd', probs, v)


def sp_mha(q: Array, k: Array, v: Array, mesh, axis: str = 'model',
           causal: bool = False) -> Array:
  """Sequence-parallel attention: (B, L, H, D) with L sharded over a
  mesh axis. Each device holds an L/N chunk of q/k/v; K and V are
  all-gathered over the interconnect and each device attends its local queries to
  the full keys/values, so activations (not just weights) scale past
  one device's memory. Causal masking uses global positions recovered from
  the device's axis index.

  The reference has no sequence/context parallelism of any kind
  (SURVEY.md §2.2); this serves the long-context text-MDLM configs.
  """
  from jax.sharding import PartitionSpec as P
  from jax.experimental.shard_map import shard_map

  n_shards = mesh.shape[axis]
  l_local = q.shape[1] // n_shards

  def local(q_c, k_c, v_c):
    idx = jax.lax.axis_index(axis)
    k_full = jax.lax.all_gather(k_c, axis, axis=1, tiled=True)
    v_full = jax.lax.all_gather(v_c, axis, axis=1, tiled=True)
    d = q_c.shape[-1]
    logits = jnp.einsum('blhd,bmhd->bhlm', q_c, k_full,
                        preferred_element_type=jnp.float32)
    logits = logits / math.sqrt(d)
    if causal:
      rows = jax.lax.broadcasted_iota(
          jnp.int32, logits.shape[-2:], 0) + idx * l_local
      cols = jax.lax.broadcasted_iota(jnp.int32, logits.shape[-2:], 1)
      logits = jnp.where(rows >= cols, logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1).astype(v_c.dtype)
    return jnp.einsum('bhlm,bmhd->blhd', probs, v_full)

  spec = P(None, axis, None, None)
  return shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec)(q, k, v)
