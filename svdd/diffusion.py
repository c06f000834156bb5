"""The Diffusion model: backbone + schedule + parameterization + samplers.

Counterpart of the reference ``Diffusion(L.LightningModule)``
(reference diffusion_gosai.py:74-1888). Instead of a stateful
LightningModule, this is a thin immutable bundle of (config, flax
backbone, schedule) exposing pure jitted functions:

  forward / forward_onehot   — log p(x0|xt) with parameterization
                               (diffusion_gosai.py:339-378)
  loss                       — NELBO / D3PM / SEDD training loss
                               (:1709-1779)
  sample / decode_sample     — uncontrolled reverse process (:821-936)
  controlled_sample          — SVDD-MC (:1022-1062)
  controlled_sample_tweedie  — SVDD-PM (:1106-1145)
  controlled_sample_TDS/_DPS/_classfier — baselines (:938-1104)

All samplers are single jitted lax.scan programs (sampling/sampler.py);
guidance plugs in as step transforms (sampling/guidance.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from svdd import mdlm, schedules
from svdd.config import Config
from svdd.models.cnn import CNNModel
from svdd.sampling import guidance as G
from svdd.sampling import sampler as S

Array = jnp.ndarray


def build_backbone(config: Config):
  """Backbone factory (diffusion_gosai.py:96-127)."""
  dtype = (jnp.bfloat16 if config.parallel.precision == 'bf16'
           else jnp.float32)
  if config.backbone == 'cnn':
    # fp32 by default like the reference's autocast pin
    # (diffusion_gosai.py:345). SVDD_CNN_BF16=1 opts into bf16 compute.
    import os
    cnn_dtype = (jnp.bfloat16 if os.environ.get('SVDD_CNN_BF16') == '1'
                 else jnp.float32)
    return CNNModel(config=config, alphabet_size=config.vocab_size,
                    num_cls=3, compute_dtype=cnn_dtype)
  if config.backbone == 'dit':
    from svdd.models.dit import DIT
    return DIT(config=config, vocab_size=config.vocab_size,
               compute_dtype=dtype)
  if config.backbone == 'dimamba':
    from svdd.models.dimamba import DiMamba
    return DiMamba(config=config, vocab_size=config.vocab_size,
                   compute_dtype=dtype)
  if config.backbone == 'ar':
    from svdd.models.autoregressive import ARModel
    return ARModel(config=config, vocab_size=config.vocab_size,
                   compute_dtype=dtype)
  raise ValueError(f'unknown backbone {config.backbone}')


class Diffusion:
  """Immutable model bundle; all methods are pure given ``variables``."""

  def __init__(self, config: Config, variables: Any | None = None,
               rng: jax.Array | None = None):
    self.config = config
    self.vocab_size = config.vocab_size
    self.mask_index = config.mask_index
    self.parameterization = config.parameterization
    self.time_conditioning = config.time_conditioning
    self.T = config.T
    self.backbone = build_backbone(config)
    self.schedule = schedules.get_schedule(
        config.noise.type, sigma_min=config.noise.sigma_min,
        sigma_max=config.noise.sigma_max, eps=config.noise.eps)
    if variables is None:
      if rng is None:
        rng = jax.random.key(config.seed)
      dummy = jnp.zeros((1, config.model.length), jnp.int32)
      # jit the init: one program instead of per-op eager dispatch
      variables = jax.jit(self.backbone.init)(rng, dummy,
                                              jnp.zeros((1,)))
    self.variables = variables

  # -- denoiser forwards ----------------------------------------------------

  def _process_sigma(self, sigma: Array) -> Array:
    """time_conditioning=False zeroes sigma (diffusion_gosai.py:329-337) —
    the default for both bio tasks."""
    if sigma.ndim > 1:
      sigma = jnp.squeeze(sigma, -1)
    if not self.time_conditioning:
      sigma = jnp.zeros_like(sigma)
    return sigma

  def _parameterize(self, logits: Array, xt: Array, sigma: Array) -> Array:
    if self.parameterization == 'subs':
      return mdlm.subs_parameterization(logits, xt, self.mask_index)
    if self.parameterization == 'sedd':
      return mdlm.sedd_parameterization(logits, xt, sigma)
    if self.parameterization == 'd3pm':
      return mdlm.d3pm_parameterization(
          logits, self.mask_index, self.config.subs_masking)
    return logits   # 'ar'

  def forward(self, variables: Any, x: Array, sigma: Array) -> Array:
    """log p(x0 | xt): backbone + parameterization (:339-357)."""
    sigma = self._process_sigma(sigma)
    logits = self.backbone.apply(variables, x, sigma)
    return self._parameterize(logits, x, sigma)

  def forward_onehot(self, variables: Any, x_onehot: Array, x: Array,
                     sigma: Array) -> Array:
    """'forward2': one-hot input for gradient guidance (:359-378)."""
    sigma = self._process_sigma(sigma)
    logits = self.backbone.apply(variables, x, sigma, x_onehot=x_onehot)
    return self._parameterize(logits, x, sigma)

  def denoise_fn(self, variables: Any | None = None) -> S.DenoiseFn:
    variables = self.variables if variables is None else variables
    return lambda x, sigma: self.forward(variables, x, sigma)

  def denoise_onehot_fn(self, variables: Any | None = None):
    variables = self.variables if variables is None else variables
    return lambda oh, x, sigma: self.forward_onehot(variables, oh, x,
                                                    sigma)

  # -- training loss --------------------------------------------------------

  def loss(self, variables: Any, key: jax.Array, x0: Array,
           attention_mask: Array | None = None,
           train: bool = False, dropout_rng: jax.Array | None = None,
           apply_fn: Any | None = None) -> mdlm.LossOutput:
    """Diffusion training loss (_loss/_forward_pass_diffusion,
    diffusion_gosai.py:1709-1779).

    apply_fn optionally replaces ``self.backbone.apply`` for the
    denoiser forward — used by the pipeline-parallel training path
    (parallel/pipeline.pipelined_backbone_apply), which computes the
    same logits with the block stack sharded over a 'pipe' mesh axis.
    """
    cfg = self.config
    backbone_apply = (self.backbone.apply if apply_fn is None
                      else apply_fn)
    if self.parameterization == 'ar':
      # AR baseline: shifted next-token NLL, no diffusion machinery
      # (_loss 'ar' branch + _maybe_sub_sample input/output split,
      # diffusion_gosai.py:1671-1697, 1763-1767). Sub-sampling for
      # seqlen > model.length raises NotImplementedError in the
      # reference too (:1674).
      if x0.shape[1] > cfg.model.length:
        raise NotImplementedError('sub-sampling not implemented '
                                  '(reference parity)')
      input_tokens, output_tokens = x0[:, :-1], x0[:, 1:]
      if attention_mask is None:
        attention_mask = jnp.ones(x0.shape, jnp.float32)
      mask = attention_mask[:, 1:]
      rngs = ({'dropout': dropout_rng} if dropout_rng is not None
              else None)
      logprobs = backbone_apply(variables, input_tokens, None,
                                train=train, rngs=rngs)
      nll = -jnp.take_along_axis(logprobs, output_tokens[..., None],
                                 -1)[..., 0]
      nlls = nll * mask
      return mdlm.LossOutput(nlls.sum() / mask.sum(), nlls, mask)
    kt, kq = jax.random.split(key)
    t = mdlm.sample_t(kt, x0.shape[0], cfg.training.sampling_eps,
                      cfg.training.antithetic_sampling)
    if cfg.training.importance_sampling:
      t = self.schedule.importance_transform(t)
    if self.T > 0:
      t = (t * self.T).astype(jnp.int32).astype(jnp.float32) / self.T
      t = t + 1.0 / self.T

    sigma, dsigma = self.schedule(t)
    move_chance = (1 - jnp.exp(-sigma))[:, None]
    xt = mdlm.q_xt(kq, x0, move_chance, self.mask_index)

    sigma_in = self._process_sigma(sigma)
    rngs = {'dropout': dropout_rng} if dropout_rng is not None else None
    logits = backbone_apply(variables, xt, sigma_in, train=train,
                            rngs=rngs)
    model_output = self._parameterize(logits, xt, sigma)

    if self.parameterization == 'sedd':
      loss = dsigma[:, None] * mdlm.score_entropy(
          model_output, sigma[:, None], xt, x0, self.mask_index)
    elif self.T > 0:
      loss = mdlm.d3pm_loss(model_output, xt, x0, t, self.mask_index,
                            self.T)
      if self.parameterization == 'd3pm':
        # reconstruction term (diffusion_gosai.py:1697-1707)
        t0 = jnp.zeros(x0.shape[0])
        sigma_t0 = self.schedule.total(t0)
        logits0 = backbone_apply(
            variables, x0, self._process_sigma(sigma_t0), train=train,
            rngs=rngs)
        out0 = self._parameterize(logits0, x0, sigma_t0)
        recon = -jnp.take_along_axis(out0, x0[..., None], -1)[..., 0]
        loss = loss + recon
    else:
      return mdlm.nelbo_subs(model_output, x0, sigma, dsigma,
                             attention_mask)

    if attention_mask is None:
      attention_mask = jnp.ones_like(loss)
    nlls = loss * attention_mask
    return mdlm.LossOutput(nlls.sum() / attention_mask.sum(), nlls,
                           attention_mask)

  # -- samplers -------------------------------------------------------------
  #
  # All sampler factories jit a function whose MODEL VARIABLES ARE
  # ARGUMENTS, not closures: JAX inlines closed-over arrays as HLO
  # constants, and baking the ~10^8-param value net into the program
  # makes compiles slow and the program weight-specific. User
  # value/reward functions are passed either as plain callables
  # (captured arrays become constants — fine for tiny synthetic
  # oracles) or as a ``(apply_fn, variables)`` pair whose variables are
  # hoisted to jit arguments (what the CLIs and bench do).

  @staticmethod
  def _hoist(fn_or_pair):
    if isinstance(fn_or_pair, tuple):
      apply_fn, variables = fn_or_pair
      return apply_fn, variables
    if fn_or_pair is None:
      return None, ()
    return (lambda _vars, *args: fn_or_pair(*args)), ()

  def _base_kwargs(self, batch_size: int, num_steps: Optional[int],
                   eps: float):
    cfg = self.config
    return dict(
        batch_size=batch_size,
        length=cfg.model.length,
        mask_index=self.mask_index,
        vocab_size=self.vocab_size,
        num_steps=num_steps or cfg.sampling.steps,
        eps=eps,
        noise_removal=cfg.sampling.noise_removal,
        analytic_removal=cfg.sampling.predictor == 'analytic',
    )

  def _jit_sampler(self, build_step, batch_size, num_steps, eps,
                   variables=None, extra_vars=(), mesh=None,
                   collect_mid=False, collect_aux=False, tp=False,
                   removal_from_aux=False):
    """build_step(denoise, extra_vars) -> (step_fn, aux_init),
    called inside the traced function so every captured array is a
    traced jit argument.

    With a mesh, the scan carry pins to P('data') and the folded
    (B*M,) candidate rows to ALL devices (candidate_sharding) — unless
    ``tp=True``, where the value net is weight-sharded over 'model'
    (mesh.tp_shard_value_params) so candidates stay on 'data' only."""
    den_vars = self.variables if variables is None else variables
    shard = shard_flat = None
    if mesh is not None:
      from jax.sharding import NamedSharding, PartitionSpec as P
      from svdd.parallel import mesh as M
      sharding = NamedSharding(mesh, P('data', None))
      shard = lambda x: jax.lax.with_sharding_constraint(x, sharding)
      flat_sharding = (NamedSharding(mesh, P('data', None)) if tp
                       else M.candidate_sharding(mesh))
      shard_flat = lambda x: jax.lax.with_sharding_constraint(
          x, flat_sharding)
    base = self._base_kwargs(batch_size, num_steps, eps)

    def sample(den_vars, extra_vars, key):
      denoise = lambda x, sigma: self.forward(den_vars, x, sigma)
      step_fn, aux_init = build_step(denoise, den_vars, extra_vars,
                                     shard_flat)
      fn = S.reverse_process(
          step_fn, denoise, self.schedule,
          collect_mid=collect_mid, collect_aux=collect_aux,
          removal_from_aux=removal_from_aux,
          aux_init=aux_init, shard_constraint=shard, **base)
      return fn(key)

    jitted = jax.jit(sample)

    class _Sampler:
      """key -> SampleResult; exposes the underlying jitted fn for
      cached cost analysis / AOT serialization (svdd.aot).
      ``variables`` overrides the denoiser params per call WITHOUT
      recompiling (they are jit arguments) — the in-training
      sample-quality eval reuses one compiled sampler across EMA
      snapshots this way."""

      jitted_fn = staticmethod(jitted)
      default_args = (den_vars, extra_vars)

      def __call__(self, key, variables=None):
        return jitted(den_vars if variables is None else variables,
                      extra_vars, key)

      def cost_analysis(self, key):
        compiled = jitted.lower(den_vars, extra_vars, key).compile()
        cost = compiled.cost_analysis()
        return cost[0] if isinstance(cost, (list, tuple)) else cost

    return _Sampler()

  def sampler(self, batch_size: int, *, num_steps: int | None = None,
              eps: float = 1e-5, collect_mid: bool = False,
              variables: Any | None = None, mesh: Any = None):
    """Uncontrolled sampler (_sample/decode_sample,
    diffusion_gosai.py:821-936). Returns jitted key -> SampleResult."""
    pred = self.config.sampling.predictor

    def build(denoise, den_vars, extra, shard_flat=None):
      if pred == 'ddpm':
        return S.ddpm_step(denoise, self.schedule, self.mask_index), ()
      if pred == 'ddpm_cache':
        aux_init = (jnp.zeros((batch_size, self.config.model.length,
                               self.vocab_size)), jnp.asarray(False))
        return S.ddpm_cache_step(denoise, self.schedule,
                                 self.mask_index), aux_init
      if pred == 'analytic':
        return S.analytic_step(denoise, self.schedule, self.mask_index,
                               self.vocab_size), ()
      raise ValueError(pred)

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, mesh=mesh,
                             collect_mid=collect_mid)

  def cdq_sampler(self, batch_size: int, *, repeats: int = 10,
                  num_steps: int | None = None, eps: float = 1e-5,
                  variables: Any | None = None, mesh: Any = None):
    """CDQ trajectory collection (_sample(cdq=True),
    diffusion_gosai.py:839-853): returns SampleResult whose ``extra``
    stacks all per-step candidate rollouts (steps, B, M, L) and whose
    mid_x stacks trajectory states. With a mesh the trajectory batch
    shards over 'data' (DP value training)."""

    def build(denoise, den_vars, extra, shard_flat=None):
      aux_init = jnp.zeros(
          (batch_size, repeats, self.config.model.length), jnp.int32)
      return G.cdq_step(denoise, self.schedule, self.mask_index,
                        repeats), aux_init

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, collect_mid=True,
                             collect_aux=True, mesh=mesh)

  def controlled_sampler(self, value_fn, batch_size: int, *,
                         sample_M: int = 10, num_steps: int | None = None,
                         eps: float = 1e-5, variables: Any | None = None,
                         mesh: Any = None, tp: bool = False,
                         m_schedule=None):
    """SVDD-MC (controlled_sample, diffusion_gosai.py:1022-1062).
    ``value_fn``: tokens->(N,) callable, or (apply_fn, variables).

    With a mesh, the folded B*M candidate batch is sharded over ALL
    devices (candidate_sharding). ``tp=True`` instead weight-shards the
    value net over the 'model' axis (pass value variables through
    mesh.tp_shard_value_params) and keeps candidates on 'data'.

    ``m_schedule``: opt-in SCHEDULED-M decode — a sequence of
    (n_steps_i, M_i) phases covering the trajectory, e.g.
    ((64, 4), (64, 10)) draws/scores 4 candidates per step for the
    first 64 steps and 10 for the last 64. Rationale: the per-step
    cost is dominated by the B*M value forward (diffusion_gosai.py:
    1203-1209) while early near-all-mask steps unmask few positions.
    Overrides ``sample_M``; each phase is its own static-shape scan
    (sampler.reverse_process phases)."""
    apply_fn, val_vars = self._hoist(value_fn)

    def build(denoise, den_vars, val_vars, shard_flat=None):
      vfn = lambda tokens: apply_fn(val_vars, tokens)
      mk = lambda m: G.svdd_mc_step(denoise, vfn, self.schedule,
                                    self.mask_index, repeats=m,
                                    shard_flat=shard_flat)
      if m_schedule is None:
        return mk(sample_M), ()
      return [(mk(m), int(n)) for n, m in m_schedule], ()

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=val_vars,
                             mesh=mesh, tp=tp)

  def controlled_sampler_timed(self, value_fn_timed, batch_size: int, *,
                               sample_M: int = 10,
                               num_steps: int | None = None,
                               eps: float = 1e-5,
                               variables: Any | None = None,
                               mesh: Any = None):
    """SVDD-MC with step-indexed value fn (timed / multisep models)."""
    steps = num_steps or self.config.sampling.steps
    apply_fn, val_vars = self._hoist(value_fn_timed)

    def build(denoise, den_vars, val_vars, shard_flat=None):
      vfn = lambda tokens, step_idx: apply_fn(val_vars, tokens, step_idx)
      return G.svdd_mc_step_timed(denoise, vfn, self.schedule,
                                  self.mask_index, steps, eps,
                                  repeats=sample_M,
                                  shard_flat=shard_flat), ()

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=val_vars,
                             mesh=mesh)

  def _posterior_aux_init(self, denoise, batch_size):
    """(log_p, valid=False) carry for the carry_posterior reuse paths —
    shape/dtype derived from the actual denoiser forward so the
    lax.cond branches in _cached_or_fresh match exactly."""
    shp = jax.eval_shape(
        denoise, jnp.zeros((batch_size, self.config.model.length),
                           jnp.int32), jnp.zeros((batch_size,)))
    return (jnp.zeros(shp.shape, shp.dtype), jnp.asarray(False))

  def tweedie_sampler(self, reward_fn, batch_size: int, *,
                      sample_M: int = 10, tweedie: bool = True,
                      task: str = 'dna', saluki_body=None,
                      saluki_final_length: int = 12288,
                      num_steps: int | None = None, eps: float = 1e-5,
                      variables: Any | None = None, mesh: Any = None,
                      reuse_posterior: bool = True,
                      m_schedule=None):
    """SVDD-PM (controlled_sample_tweedie, diffusion_gosai.py:1106-1145).
    ``task='rna_saluki'`` routes scoring through the saluki input
    builder (:1426-1428).

    ``reuse_posterior`` (tweedie only; default on): carry the winner's
    candidate forward across steps and into noise removal, dropping the
    per-step (B,) denoiser forward AND the final removal forward —
    mathematically exact (guidance._cached_or_fresh).

    ``m_schedule``: opt-in scheduled-M phases ((n_steps_i, M_i), ...)
    — see controlled_sampler; for PM both the candidate denoiser
    forward AND the reward forward scale with M, so the early-phase
    saving is larger than MC's."""
    apply_fn, rew_vars = self._hoist(reward_fn)
    reuse = reuse_posterior and tweedie

    def build(denoise, den_vars, rew_vars, shard_flat=None):
      rfn = lambda onehot: apply_fn(rew_vars, onehot)
      aux_init = (self._posterior_aux_init(denoise, batch_size)
                  if reuse else ())
      mk = lambda m: G.svdd_pm_step(denoise, rfn, self.schedule,
                                    self.mask_index, repeats=m,
                                    tweedie=tweedie, task=task,
                                    saluki_body=saluki_body,
                                    saluki_final_length=saluki_final_length,
                                    shard_flat=shard_flat,
                                    carry_posterior=reuse)
      if m_schedule is None:
        return mk(sample_M), aux_init
      return [(mk(m), int(n)) for n, m in m_schedule], aux_init

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=rew_vars,
                             mesh=mesh, removal_from_aux=reuse)

  def tds_sampler(self, reward_fn, batch_size: int, *, alpha: float = 1.0,
                  num_steps: int | None = None, eps: float = 1e-5,
                  variables: Any | None = None, mesh: Any = None,
                  reuse_posterior: bool = True,
                  track_ess: bool = True,
                  ess_threshold: float | None = None):
    """TDS SMC baseline (controlled_sample_TDS, diffusion_gosai.py:938-978).

    ``reuse_posterior`` (default on): carry the resampled particles'
    reward_num forward across steps — one of the three per-step
    denoiser forwards and the removal forward drop out, exactly.

    ``track_ess`` (default on): the SampleResult.extra aux dict carries
    a per-step effective-sample-size trace under ``'ess'`` — at the
    reference's published alpha=0.5 the particle set silently collapses
    to ESS~1 and this is the only way a user sees it.
    ``ess_threshold`` (opt-in): adaptive resampling — accumulate
    weights and resample only when ESS < ess_threshold * B (see
    guidance.tds_step)."""
    apply_fn, rew_vars = self._hoist(reward_fn)
    steps = num_steps or self.config.sampling.steps

    def build(denoise, den_vars, rew_vars, shard_flat=None):
      rfn = lambda onehot: apply_fn(rew_vars, onehot)
      post_init = (self._posterior_aux_init(denoise, batch_size)
                   if reuse_posterior else ())
      aux_init = G.tds_aux_init(batch_size, post_init,
                                track_ess=track_ess, num_steps=steps,
                                ess_threshold=ess_threshold)
      return G.tds_step(denoise, rfn, self.schedule, self.mask_index,
                        alpha=alpha,
                        carry_posterior=reuse_posterior,
                        track_ess=track_ess, num_steps=steps,
                        ess_threshold=ess_threshold), aux_init

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=rew_vars,
                             mesh=mesh,
                             removal_from_aux=reuse_posterior)

  def dps_sampler(self, reward_fn, batch_size: int, *,
                  guidance_scale: float = 1.0,
                  num_steps: int | None = None, eps: float = 1e-5,
                  variables: Any | None = None, mesh: Any = None):
    """DPS baseline (controlled_sample_DPS, diffusion_gosai.py:980-1020)."""
    apply_fn, rew_vars = self._hoist(reward_fn)

    def build(denoise, den_vars, rew_vars, shard_flat=None):
      rfn = lambda onehot: apply_fn(rew_vars, onehot)
      donehot = lambda oh, x, sigma: self.forward_onehot(den_vars, oh,
                                                         x, sigma)
      return G.dps_step(donehot, rfn, self.schedule, self.mask_index,
                        guidance_scale=guidance_scale), ()

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=rew_vars,
                             mesh=mesh)

  def classifier_sampler(self, value_fn_onehot, batch_size: int, *,
                         guidance_scale: float = 1.0,
                         num_steps: int | None = None, eps: float = 1e-5,
                         variables: Any | None = None, mesh: Any = None):
    """Classifier guidance (controlled_sample_classfier,
    diffusion_gosai.py:1064-1104)."""
    apply_fn, val_vars = self._hoist(value_fn_onehot)

    def build(denoise, den_vars, val_vars, shard_flat=None):
      vfn = lambda onehot: apply_fn(val_vars, onehot)
      return G.classifier_step(denoise, vfn, self.schedule,
                               self.mask_index,
                               guidance_scale=guidance_scale), ()

    return self._jit_sampler(build, batch_size, num_steps, eps,
                             variables=variables, extra_vars=val_vars,
                             mesh=mesh)
