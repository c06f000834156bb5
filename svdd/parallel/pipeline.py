"""Pipeline parallelism: GPipe microbatch schedule over a 'pipe' mesh
axis.

Beyond-reference capability (the reference is data-parallel only,
SURVEY.md §2.2): uniform transformer stacks (DiT blocks, Enformer
transformer tower) are split into S stages, one per device along the
'pipe' axis; microbatches stream through the stages with activations
handed over by `lax.ppermute` over ICI. The whole schedule is one
`lax.scan` of M + S - 1 ticks inside a single `shard_map` — XLA sees a
static program, no host round-trips.

Differentiable by construction: `ppermute`'s transpose is the reverse
permute, so `jax.grad` through `gpipe` yields the standard GPipe
backward schedule automatically (activations for the backward are the
scan's saved carries; wrap `stage_fn` in `jax.checkpoint` to trade
recompute for memory at scale).

Bubble fraction is the usual (S-1)/(M+S-1); pick num_microbatches >= 4x
the stage count for >80% utilization.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

PIPE_AXIS = 'pipe'

Array = jnp.ndarray


def stack_stage_params(per_block_params: list, blocks_per_stage: int
                       ) -> Any:
  """[L block param trees] -> one tree with leaves (S, k, ...) where
  L = S*k: stage-major stacking for `gpipe` (shard leading dim over
  'pipe')."""
  n = len(per_block_params)
  assert n % blocks_per_stage == 0, (n, blocks_per_stage)
  stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per_block_params)
  return jax.tree.map(
      lambda x: x.reshape((n // blocks_per_stage, blocks_per_stage)
                          + x.shape[1:]),
      stacked)


def gpipe(stage_fn: Callable, stage_params: Any, x: Array,
          mb_args: tuple = (), bcast_args: tuple = (), *,
          mesh: Mesh, num_microbatches: int,
          axis_name: str = PIPE_AXIS) -> Array:
  """Run x through S pipelined stages.

  stage_fn(params_k, x_mb, *mb_args_mb, *bcast_args) -> y_mb with
  y_mb.shape == x_mb.shape; params_k is one stage's (k, ...) sub-stack
  (scan over k inside stage_fn for multi-block stages).

  stage_params: leaves (S, k, ...) — sharded over 'pipe'.
  x: (B, ...) — microbatched into (M, B/M, ...); B % M == 0.
  mb_args: per-sample side inputs split like x (e.g. adaLN cond (B,C)).
  bcast_args: replicated side inputs (e.g. rotary cos/sin tables).
  Returns (B, ...) replicated across the pipe axis.
  """
  from jax.experimental.shard_map import shard_map

  s = mesh.shape[axis_name]
  m = num_microbatches
  b = x.shape[0]
  assert b % m == 0, (b, m)

  def to_mb(a):
    return a.reshape((m, b // m) + a.shape[1:])

  x_mbs = to_mb(x)
  mb_mbs = tuple(to_mb(a) for a in mb_args)

  def worker(params, x_mbs, mb_mbs, bcast):
    # shard_map gives this device its (1, k, ...) params slice
    params = jax.tree.map(lambda p: p[0], params)
    stage = jax.lax.axis_index(axis_name)
    zero_mb = jnp.zeros_like(x_mbs[0])
    outs0 = jnp.zeros_like(x_mbs)

    def tick(carry, t):
      cur, outs = carry
      mi = jnp.clip(t - stage, 0, m - 1)
      inp = jnp.where(stage == 0,
                      jax.lax.dynamic_index_in_dim(x_mbs, mi, 0,
                                                   keepdims=False),
                      cur)
      mbs_t = tuple(
          jax.lax.dynamic_index_in_dim(a, mi, 0, keepdims=False)
          for a in mb_mbs)
      out = stage_fn(params, inp, *mbs_t, *bcast)
      # last stage deposits microbatch t-(S-1) into the output buffer
      oi = t - (s - 1)
      valid = jnp.logical_and(stage == s - 1, oi >= 0)
      oi_c = jnp.clip(oi, 0, m - 1)
      prev = jax.lax.dynamic_index_in_dim(outs, oi_c, 0,
                                          keepdims=False)
      outs = jax.lax.dynamic_update_index_in_dim(
          outs, jnp.where(valid, out, prev), oi_c, 0)
      # hand my activation to the next stage (wrap to 0 is ignored)
      nxt = jax.lax.ppermute(out, axis_name,
                             [(i, (i + 1) % s) for i in range(s)])
      return (nxt, outs), None

    (_, outs), _ = jax.lax.scan(
        tick, (zero_mb, outs0), jnp.arange(m + s - 1))
    # replicate the last stage's buffer everywhere
    outs = jax.lax.psum(
        jnp.where(stage == s - 1, outs, jnp.zeros_like(outs)),
        axis_name)
    return outs

  spec_p = jax.tree.map(lambda _: P(axis_name), stage_params)
  out = shard_map(
      worker, mesh=mesh,
      in_specs=(spec_p, P(), P(), P()),
      out_specs=P(),
      check_rep=False,
  )(stage_params, x_mbs, mb_mbs, bcast_args)
  return out.reshape((b,) + x.shape[1:])


def stack_stage_params_interleaved(per_block_params: list,
                                   blocks_per_chunk: int,
                                   virtual: int) -> Any:
  """[L block trees] -> leaves (S, V, k, ...) for gpipe_interleaved:
  virtual stage j = v*S + d holds blocks [j*k, (j+1)*k); device d's
  chunk v is leaf[d, v]."""
  n = len(per_block_params)
  assert n % (blocks_per_chunk * virtual) == 0
  s = n // (blocks_per_chunk * virtual)
  stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per_block_params)

  def rearrange(x):
    # (L, ...) -> (V, S, k, ...) virtual-stage-major -> (S, V, k, ...)
    x = x.reshape((virtual, s, blocks_per_chunk) + x.shape[1:])
    return jnp.swapaxes(x, 0, 1)
  return jax.tree.map(rearrange, stacked)


def gpipe_interleaved(stage_fn: Callable, stage_params: Any, x: Array,
                      mb_args: tuple = (), bcast_args: tuple = (), *,
                      mesh: Mesh, virtual: int,
                      axis_name: str = PIPE_AXIS) -> Array:
  """Interleaved (Megatron-style virtual-stage) pipeline schedule.

  Each device holds ``virtual`` NON-contiguous layer chunks (device d
  owns virtual stages d, d+S, ..., d+(V-1)S); every microbatch rides
  the ring V times. With M = S microbatches the bubble drops from
  GPipe's (S-1)/(2S-1) to (S-1)/(V*S + S - 1) — e.g. 4 stages, V=2:
  43% -> 27% idle. This is the LOW-LATENCY schedule: for M >> S plain
  `gpipe` already amortizes its single fill/drain and does fewer,
  larger stage calls — use it instead (the classic 1F1B memory
  argument doesn't apply here: XLA's autodiff schedules the backward,
  and activation memory is the scan's saved carries either way).

  stage_fn(params_k, x_mb, *mb_args_mb, *bcast_args) with params_k one
  (k, ...) chunk; stage_params leaves (S, V, k, ...)
  (stack_stage_params_interleaved). Microbatch count is fixed at S.
  """
  from jax.experimental.shard_map import shard_map

  s = mesh.shape[axis_name]
  v_chunks = virtual
  b = x.shape[0]
  m = s                      # microbatches == stages (see docstring)
  assert b % m == 0, (b, m)

  def to_mb(a):
    return a.reshape((m, b // m) + a.shape[1:])

  x_mbs = to_mb(x)
  mb_mbs = tuple(to_mb(a) for a in mb_args)
  n_ticks = v_chunks * s + s - 1

  def worker(params, x_mbs, mb_mbs, bcast):
    params = jax.tree.map(lambda p: p[0], params)    # (V, k, ...)
    stage = jax.lax.axis_index(axis_name)
    outs0 = jnp.zeros_like(x_mbs)

    def tick(carry, t):
      cur, outs = carry
      rel = t - stage
      mi = jnp.clip(rel % s, 0, m - 1)
      vi = jnp.clip(rel // s, 0, v_chunks - 1)
      inject = jnp.logical_and(stage == 0,
                               jnp.logical_and(rel >= 0, rel < s))
      inp = jnp.where(
          inject,
          jax.lax.dynamic_index_in_dim(x_mbs, jnp.clip(t, 0, m - 1),
                                       0, keepdims=False),
          cur)
      params_v = jax.tree.map(
          lambda p: jax.lax.dynamic_index_in_dim(p, vi, 0,
                                                 keepdims=False),
          params)
      mbs_t = tuple(
          jax.lax.dynamic_index_in_dim(a, mi, 0, keepdims=False)
          for a in mb_mbs)
      out = stage_fn(params_v, inp, *mbs_t, *bcast)
      # device S-1 finishing chunk V-1 deposits microbatch mi
      valid = jnp.logical_and(stage == s - 1, rel // s == v_chunks - 1)
      prev = jax.lax.dynamic_index_in_dim(outs, mi, 0, keepdims=False)
      outs = jax.lax.dynamic_update_index_in_dim(
          outs, jnp.where(valid, out, prev), mi, 0)
      nxt = jax.lax.ppermute(out, axis_name,
                             [(i, (i + 1) % s) for i in range(s)])
      return (nxt, outs), None

    (_, outs), _ = jax.lax.scan(
        tick, (jnp.zeros_like(x_mbs[0]), outs0), jnp.arange(n_ticks))
    outs = jax.lax.psum(
        jnp.where(stage == s - 1, outs, jnp.zeros_like(outs)),
        axis_name)
    return outs

  spec_p = jax.tree.map(lambda _: P(axis_name), stage_params)
  out = shard_map(
      worker, mesh=mesh,
      in_specs=(spec_p, P(), P(), P()),
      out_specs=P(),
      check_rep=False,
  )(stage_params, x_mbs, mb_mbs, bcast_args)
  return out.reshape((b,) + x.shape[1:])


def pipeline_dit_forward(dit, variables: Any, indices: Array,
                         sigma: Array, *, mesh: Mesh,
                         num_microbatches: int,
                         virtual: int = 1,
                         axis_name: str = PIPE_AXIS) -> Array:
  """Inference forward of a DIT backbone with its block stack
  pipelined over the 'pipe' mesh axis.

  Equivalent to ``dit.apply(variables, indices, sigma)`` (eval mode):
  embedding, timestep conditioning and the final layer run replicated;
  the n_blocks DDiTBlocks are split into mesh.shape[axis] stages.
  n_blocks must divide evenly by the stage count. ``virtual > 1``
  switches to the interleaved low-latency schedule
  (gpipe_interleaved; microbatch count becomes the stage count).
  """
  from svdd.models.dit import (DDiTBlock, DDitFinalLayer,
                                   TimestepEmbedder, rotary_cos_sin)

  params = variables['params']
  mcfg = dit.config.model
  dim = mcfg.hidden_size
  s = mesh.shape[axis_name]
  assert mcfg.n_blocks % s == 0, (mcfg.n_blocks, s)

  x = params['vocab_embed'][indices].astype(dit.compute_dtype)
  c = jax.nn.silu(TimestepEmbedder(mcfg.cond_dim).apply(
      {'params': params['TimestepEmbedder_0']}, sigma))
  c = c.astype(dit.compute_dtype)
  cos, sin = rotary_cos_sin(x.shape[1], dim // mcfg.n_heads)
  cos = cos.astype(dit.compute_dtype)
  sin = sin.astype(dit.compute_dtype)

  blk = DDiTBlock(dim, mcfg.n_heads, mcfg.cond_dim,
                  dropout=mcfg.dropout)
  per_block = [params[f'block_{i}'] for i in range(mcfg.n_blocks)]

  def stage_fn(params_k, h, c, cos, sin):
    h, _ = jax.lax.scan(
        lambda h, p: (blk.apply({'params': p}, h, cos, sin, c), None),
        h, params_k)
    return h

  if virtual > 1:
    stacked = stack_stage_params_interleaved(
        per_block, mcfg.n_blocks // (s * virtual), virtual)
    x = gpipe_interleaved(stage_fn, stacked, x, mb_args=(c,),
                          bcast_args=(cos, sin), mesh=mesh,
                          virtual=virtual, axis_name=axis_name)
  else:
    stacked = stack_stage_params(per_block, mcfg.n_blocks // s)
    x = gpipe(stage_fn, stacked, x, mb_args=(c,),
              bcast_args=(cos, sin), mesh=mesh,
              num_microbatches=num_microbatches, axis_name=axis_name)
  x = DDitFinalLayer(dim, dit.vocab_size, mcfg.cond_dim).apply(
      {'params': params['DDitFinalLayer_0']}, x, c)
  return x.astype(jnp.float32)


def pipelined_backbone_apply(dit, *, mesh: Mesh,
                             num_microbatches: int = 0,
                             virtual: int = 1,
                             axis_name: str = PIPE_AXIS):
  """Drop-in replacement for ``dit.apply`` usable as the ``apply_fn``
  of ``Diffusion.loss`` — wires pipeline parallelism into the text
  MDLM TRAINING loop (the reference trains data-parallel only,
  SURVEY §2.2; `gpipe` is differentiable by construction, so jax.grad
  of the loss yields the GPipe backward schedule).

  The forward is deterministic (no dropout): `gpipe` stages run eval
  mode. Enforced here because silently dropping dropout would change
  training semantics.

  Intended for a pipe-only mesh; composing with a 'data' axis needs
  batch-sharded microbatches and is not wired yet.
  """
  s = mesh.shape[axis_name]
  if dit.config.model.n_blocks % (s * virtual):
    raise ValueError(
        f'n_blocks={dit.config.model.n_blocks} must divide '
        f'stages*virtual={s}*{virtual}')
  if dit.config.model.dropout:
    raise ValueError('pipelined training forward is deterministic; '
                     'set model.dropout=0 to use pipeline_stages>1')
  if num_microbatches <= 0:
    num_microbatches = 4 * s    # (S-1)/(M+S-1) bubble < 20%

  def apply_fn(variables, x, sigma, train=False, rngs=None, **kw):
    del train, rngs, kw    # deterministic forward (checked above)
    return pipeline_dit_forward(
        dit, variables, x, sigma, mesh=mesh,
        num_microbatches=num_microbatches, virtual=virtual,
        axis_name=axis_name)

  return apply_fn
