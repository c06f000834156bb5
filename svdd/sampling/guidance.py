"""Guided reverse-step transforms: SVDD-MC, SVDD-PM (Tweedie), TDS,
DPS, and classifier guidance.

Each factory returns a ``StepFn`` pluggable into
``sampler.reverse_process`` — all algorithms share one scan skeleton.

The redesign vs the reference (SURVEY.md §3.1 hot loop,
diffusion_gosai.py:1175-1460): the reference draws its M candidates and
runs M value forwards *sequentially in python* per step (:1203-1209).
Here the M candidate draws are one (B, M, L, V) gumbel argmax and the M
value forwards are ONE batched (B*M) forward — the candidate dimension
is folded into the batch so every matmul in the value net sees an
M-times-larger batch.

API conventions:
  denoise_fn(x:(N,L) int32, sigma:(N,)) -> log p(x0|xt) (N,L,V)
  denoise_onehot_fn(x_onehot:(N,L,V), x:(N,L), sigma:(N,)) -> (N,L,V)
      (the differentiable 'forward2' path, diffusion_gosai.py:359-378)
  value_fn(tokens:(N,L) int32) -> (N,) value-net scores
      (one-hot transform with mask-row zeroing happens inside)
  reward_fn(onehot:(N,L,4)) -> (N,) reward-oracle scores
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from svdd import mdlm
from svdd.sampling.sampler import DenoiseFn, StepFn
from svdd.schedules import Schedule

Array = jnp.ndarray
ValueFn = Callable[[Array], Array]
RewardFn = Callable[[Array], Array]


def _move_chances(schedule: Schedule, t: Array, t_next: Array):
  sigma_t, _ = schedule(t)
  sigma_s, _ = schedule(t_next)
  return sigma_t, sigma_s, 1 - jnp.exp(-sigma_t), 1 - jnp.exp(-sigma_s)


def _draw_candidates(key: jax.Array, log_q: Array, x: Array,
                     mask_index: int, repeats: int) -> Array:
  """One-shot (B, M, L) candidate draw: vectorized gumbel-max over an
  expanded candidate axis + carry-over of unmasked tokens
  (replaces the sequential list-comp at diffusion_gosai.py:1203)."""
  gumbel = jax.random.gumbel(
      key, (log_q.shape[0], repeats) + log_q.shape[1:], dtype=jnp.float32)
  draws = jnp.argmax(log_q[:, None] + gumbel, axis=-1)
  return jnp.where((x != mask_index)[:, None], x[:, None], draws)


def _select_best(candidates: Array, scores: Array) -> Array:
  """Per-row argmax over the M candidates (softmax+argmax in the
  reference, :1219-1227 — argmax of softmax == argmax of scores)."""
  idx = jnp.argmax(scores, axis=1)                          # (B,)
  return jnp.take_along_axis(candidates, idx[:, None, None],
                             axis=1)[:, 0]


def svdd_mc_step(denoise_fn: DenoiseFn, value_fn: ValueFn,
                 schedule: Schedule, mask_index: int,
                 repeats: int = 10, shard_flat=None) -> StepFn:
  """SVDD-MC: M candidates -> value net -> argmax select
  (_ddpm_update_finetune_controlled, diffusion_gosai.py:1175-1228).

  ``shard_flat`` pins the folded (B*M, L) candidate batch to a mesh
  sharding (parallel/mesh.candidate_sharding) so the value forward
  splits across all devices."""

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, _, mct, mcs = _move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(key, log_q, x, mask_index, repeats)
    flat = candidates.reshape(b * repeats, l)
    if shard_flat is not None:
      flat = shard_flat(flat)
    scores = value_fn(flat).reshape(b, repeats)
    return aux, _select_best(candidates, scores)

  return step


def svdd_mc_step_timed(denoise_fn: DenoiseFn, value_fn_timed,
                       schedule: Schedule, mask_index: int,
                       num_steps: int, eps: float = 1e-5,
                       repeats: int = 10, shard_flat=None) -> StepFn:
  """SVDD-MC with a step-indexed value function — serves the
  timed / multisep value models (reference TimedEnformerTrunk and
  BaseModelMultiSep, Enformer.py:1202-1268, :867-1102).

  value_fn_timed(tokens (N, L), step_idx scalar int) -> (N,).
  The scan passes scalar time t; the discrete step index is recovered
  from the timestep grid t_i = 1 - i (1-eps)/num_steps.
  """

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, _, mct, mcs = _move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(key, log_q, x, mask_index, repeats)
    step_idx = jnp.round(
        (1.0 - t) * num_steps / (1.0 - eps)).astype(jnp.int32)
    flat = candidates.reshape(b * repeats, l)
    if shard_flat is not None:
      flat = shard_flat(flat)
    scores = value_fn_timed(flat, step_idx).reshape(b, repeats)
    return aux, _select_best(candidates, scores)

  return step


def _posterior_onehot(log_p: Array, samples: Array,
                      mask_index: int) -> Array:
  """r(E[x0|x]) input: argmax of the denoiser posterior at still-masked
  positions, actual tokens elsewhere (diffusion_gosai.py:1414-1419)."""
  posterior_arg = jnp.argmax(log_p, axis=-1)               # never MASK
  posterior_oh = jax.nn.one_hot(posterior_arg, 4)
  copy = (samples != mask_index)[..., None]
  actual_oh = jax.nn.one_hot(jnp.clip(samples, 0, 3), 4)
  return jnp.where(copy, actual_oh, posterior_oh)


def _tweedie_posterior_onehot(denoise_fn: DenoiseFn, samples: Array,
                              sigma_s: Array, mask_index: int) -> Array:
  return _posterior_onehot(denoise_fn(samples, sigma_s), samples,
                           mask_index)


def _cached_or_fresh(denoise_fn: DenoiseFn, aux, x: Array,
                     sigma_t: Array):
  """First-step-only denoiser forward: ``aux = (log_p, valid)`` carries
  the previous step's candidate forward for the selected winner, which
  equals ``denoise_fn(x, sigma_t)`` exactly (this step's sigma_t IS the
  previous step's sigma_s) — the ddpm_cache reuse trick
  (diffusion_gosai.py:755-773) applied across guided steps. The fresh
  branch only ever executes on step 0 (valid=False)."""
  log_p_cache, valid = aux
  return jax.lax.cond(
      valid, lambda: log_p_cache,
      lambda: denoise_fn(x, jnp.full((x.shape[0],), sigma_t)))


def svdd_pm_step(denoise_fn: DenoiseFn, reward_fn: RewardFn,
                 schedule: Schedule, mask_index: int,
                 repeats: int = 10, tweedie: bool = True,
                 task: str = 'dna',
                 saluki_body=None,
                 saluki_final_length: int = 12288,
                 shard_flat=None,
                 carry_posterior: bool = False) -> StepFn:
  """SVDD-PM: M candidates -> posterior-mean (Tweedie) reward -> select
  (_ddpm_update_finetune_controlled_twedie, diffusion_gosai.py:1374-1460).

  ``tweedie=False`` selects the mask-to-zero heuristic (:1420-1424).
  ``task='rna_saluki'`` scores through the 12288-length 6-channel
  saluki input builder instead (:1426-1428).
  Per step: 1 denoiser fwd on (B,) + 1 denoiser fwd + 1 reward fwd on
  (B*M,) — vs the reference's (1 + 2M) sequential forwards.

  ``carry_posterior`` (tweedie only): the candidate forward at sigma_s
  already computed the WINNER's next-step log_p — carry it in aux
  ``(log_p, valid)`` and skip the per-step (B,) denoiser forward
  entirely (exact reuse; see _cached_or_fresh). The final carry also
  equals the noise-removal forward (reverse_process removal_from_aux).
  """
  carry_posterior = carry_posterior and tweedie

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, sigma_s, mct, mcs = _move_chances(schedule, t, t_next)
    if carry_posterior:
      log_p = _cached_or_fresh(denoise_fn, aux, x, sigma_t)
    else:
      log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(key, log_q, x, mask_index, repeats)
    flat = candidates.reshape(b * repeats, l)
    if shard_flat is not None:
      flat = shard_flat(flat)
    if tweedie:
      log_p_cand = denoise_fn(flat, jnp.full((b * repeats,), sigma_s))
      onehot = _posterior_onehot(log_p_cand, flat, mask_index)
    else:
      onehot = mdlm.transform_samples(flat)                # mask rows -> 0
    if task == 'rna_saluki':
      # rebuild tokens from the (possibly Tweedie-merged) one-hot and
      # feed the saluki 6-channel padded input (diffusion_gosai:1427)
      toks = jnp.where(onehot.sum(-1) > 0, jnp.argmax(onehot, -1),
                       mask_index)
      onehot = mdlm.transform_samples_saluki(
          toks, saluki_body, final_length=saluki_final_length)
    scores = reward_fn(onehot).reshape(b, repeats)
    if not carry_posterior:
      return aux, _select_best(candidates, scores)
    idx = jnp.argmax(scores, axis=1)                        # (B,)
    winner = jnp.take_along_axis(candidates, idx[:, None, None],
                                 axis=1)[:, 0]
    picked = jnp.take_along_axis(
        log_p_cand.reshape(b, repeats, l, log_p_cand.shape[-1]),
        idx[:, None, None, None], axis=1)[:, 0]
    return (picked, jnp.asarray(True)), winner

  return step


def tds_step(denoise_fn: DenoiseFn, reward_fn: RewardFn,
             schedule: Schedule, mask_index: int,
             alpha: float = 1.0,
             carry_posterior: bool = False,
             track_ess: bool = False,
             num_steps: int | None = None,
             ess_threshold: float | None = None) -> StepFn:
  """TDS: SMC with Tweedie importance weights + systematic resampling
  (_ddpm_update_finetune_controlled_TDS, diffusion_gosai.py:1231-1284).

  The reference resamples on host via np.random.choice (:1282); here
  resampling is an in-scan jax.random.choice — no device sync.
  NB the reference evaluates BOTH v_{t-1}(x_{t-1}) and v_t(x_t) at
  sigma_s (:1267, :1275); preserved.

  ``carry_posterior``: the reward_num forward at sigma_s already
  computed next step's log_p for every particle — carry the resampled
  rows in aux ``(log_p, valid)`` and drop one of the three per-step
  denoiser forwards (exact reuse; see _cached_or_fresh).

  ``track_ess`` (needs ``num_steps``): record the per-step effective
  sample size ESS = 1/sum(w_norm^2) into a (num_steps,) buffer carried
  in the aux dict — the diagnostics the reference lacks. At the
  reference's published alpha=0.5 operating point
  (reference anoter_README.md:1) the particle weights collapse to
  ESS~1 within a few steps; without this telemetry a user gets
  silently degenerate output (VERDICT r4 weak #2).

  ``ess_threshold`` (opt-in, fraction of B): ADAPTIVE resampling —
  standard SMC practice: accumulate log-weights across steps and
  resample only when ESS <= ess_threshold * B, resetting weights to
  uniform after each resample. The FINAL step always resamples: the
  accumulated weights must be realized before the trajectory ends, or
  the returned batch would be a weighted particle set silently
  presented as unweighted samples (r5 review finding). The
  reference's always-resample behaviour (the default,
  ess_threshold=None) is the special case where the weight memory is
  discarded every step; ess_threshold=1.0 fires every step whenever
  weights are non-uniform and is then draw-for-draw identical to the
  default (pinned by test_tds_adaptive_threshold_one_matches_default).
  The RNG stream is identical in both modes (jax.random.choice is
  always evaluated).

  aux layout: plain tuple (log_p, valid) / () as before unless
  track_ess or ess_threshold is set, in which case aux is a dict
  {'post': <tuple as before>, 'ess': (num_steps,), 'i': step counter,
  'log_w': (B,) accumulated log-weights (adaptive only)} — built by
  tds_aux_init; reverse_process understands the dict for
  removal_from_aux.
  """
  use_dict = track_ess or ess_threshold is not None
  if use_dict and num_steps is None:
    raise ValueError('track_ess / ess_threshold require num_steps '
                     '(ESS buffer size + terminal-resample index)')

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    k_draw, k_resample = jax.random.split(key)
    sigma_t, sigma_s, mct, mcs = _move_chances(schedule, t, t_next)
    sigma_s_b = jnp.full((b,), sigma_s)
    post = aux['post'] if use_dict else aux
    if carry_posterior:
      log_p = _cached_or_fresh(denoise_fn, post, x, sigma_t)
    else:
      log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    draw = mdlm.sample_categorical(k_draw, log_q)
    sample = jnp.where(x != mask_index, x, draw)

    log_p_sample = denoise_fn(sample, sigma_s_b)
    reward_num = reward_fn(
        _posterior_onehot(log_p_sample, sample, mask_index))
    reward_den = reward_fn(_tweedie_posterior_onehot(
        denoise_fn, x, sigma_s_b, mask_index))

    log_ratio = (reward_num - reward_den) / alpha
    if ess_threshold is None:
      # reference semantics: weights live one step, resample always
      log_w = log_ratio
    else:
      log_w = aux['log_w'] + log_ratio
    w = jax.nn.softmax(log_w)
    ess = 1.0 / jnp.sum(w * w)

    idx = jax.random.choice(k_resample, b, shape=(b,), p=w)
    if ess_threshold is None:
      take = idx
    else:
      # <= so ess_threshold=1.0 fires even at exactly-uniform weights
      # (ESS == B on early all-mask steps where every reward ties) —
      # that makes 1.0 draw-for-draw identical to the reference's
      # always-resample bootstrap. The LAST step always fires:
      # accumulated weights must be realized as a resample before the
      # trajectory ends, or the returned batch would be a weighted
      # particle set silently presented as unweighted samples.
      fire = (ess <= ess_threshold * b) | (aux['i'] >= num_steps - 1)
      take = jnp.where(fire, idx, jnp.arange(b))
    x_next = sample[take]
    post_next = ((log_p_sample[take], jnp.asarray(True))
                 if carry_posterior else post)
    if not use_dict:
      return post_next, x_next
    aux_next = dict(aux, post=post_next)
    if track_ess:
      aux_next['ess'] = aux['ess'].at[aux['i']].set(ess)
    aux_next['i'] = aux['i'] + 1
    if ess_threshold is not None:
      aux_next['log_w'] = jnp.where(fire, jnp.zeros_like(log_w),
                                    log_w)[take]
    return aux_next, x_next

  return step


def tds_aux_init(batch_size: int, posterior_init,
                 track_ess: bool = False,
                 num_steps: int | None = None,
                 ess_threshold: float | None = None):
  """Initial aux for tds_step matching its layout contract."""
  if not (track_ess or ess_threshold is not None):
    return posterior_init
  aux = {'post': posterior_init,
         'i': jnp.asarray(0, jnp.int32)}
  if track_ess:
    aux['ess'] = jnp.zeros((num_steps,), jnp.float32)
  if ess_threshold is not None:
    aux['log_w'] = jnp.zeros((batch_size,), jnp.float32)
  return aux


def dps_step(denoise_onehot_fn, reward_fn: RewardFn,
             schedule: Schedule, mask_index: int,
             guidance_scale: float = 1.0) -> StepFn:
  """DPS: gradient of r(softmax E[x0|xt]) wrt the one-hot input,
  re-centered by the mask column, applied as exp-tilting of q_xs
  (_ddpm_update_finetune_controlled_DPS + compute_gradient_DPS,
  diffusion_gosai.py:1286-1330). jax.grad replaces autograd; no
  model.train() toggle needed."""

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, sigma_s, mct, mcs = _move_chances(schedule, t, t_next)
    sigma_t_b = jnp.full((b,), sigma_t)
    sigma_s_b = jnp.full((b,), sigma_s)
    copy = (x != mask_index).astype(jnp.float32)[..., None]

    def score_mean(x_onehot):
      # gradient semantics preserved from the reference (§7.3): grad is
      # taken wrt the full 5-channel one-hot INCLUDING the mask channel,
      # through the E[x0|xt] merge and a softmax over all 5 channels.
      expected = denoise_onehot_fn(x_onehot, x, sigma_s_b)
      expected = copy * x_onehot + (1 - copy) * expected
      probs = jax.nn.softmax(expected, axis=-1)
      return reward_fn(probs[..., :4]).mean()

    x_onehot = jax.nn.one_hot(x, mask_index + 1, dtype=jnp.float32)
    x_grad = jax.grad(score_mean)(x_onehot)

    log_p0 = denoise_onehot_fn(x_onehot, x, sigma_t_b)
    log_q = mdlm.log_q_xs(log_p0, mct, mcs, mask_index)
    guidance = guidance_scale * (
        x_grad - x_grad[..., mask_index][..., None])
    draw = mdlm.sample_categorical(key, log_q + guidance)
    return aux, jnp.where(x != mask_index, x, draw)

  return step


def classifier_step(denoise_fn: DenoiseFn, value_fn_onehot,
                    schedule: Schedule, mask_index: int,
                    guidance_scale: float = 1.0) -> StepFn:
  """Classifier guidance: grad of the value net wrt one-hot x_t added
  to q_xs in PROBABILITY space before sampling
  (_ddpm_update_finetune_classfier + compute_gradient,
  diffusion_gosai.py:1332-1371). ``value_fn_onehot`` takes (N, L, 4)
  one-hots so jax.grad flows through it."""

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, _, mct, mcs = _move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)

    def score_mean(onehot4):
      return value_fn_onehot(onehot4).mean()

    x_grad4 = jax.grad(score_mean)(mdlm.transform_samples(x))
    x_grad = jnp.concatenate(
        [x_grad4, jnp.zeros_like(x_grad4[..., :1])], axis=-1)

    # reference adds the grad to q_xs in prob space (:1355); clamp at a
    # tiny positive so negative tilted probs behave like "never chosen"
    q_tilted = jnp.exp(log_q) + guidance_scale * x_grad
    draw = mdlm.sample_categorical(
        key, jnp.log(jnp.maximum(q_tilted, 1e-35)))
    return aux, jnp.where(x != mask_index, x, draw)

  return step


def cdq_step(denoise_fn: DenoiseFn, schedule: Schedule, mask_index: int,
             repeats: int = 10) -> StepFn:
  """CD-Q trajectory collection: per step draw ``repeats`` candidate
  next-states (the 10-way rollouts of diffusion_gosai.py:839-853),
  keep the last as the trajectory, emit all for bootstrapped targets.
  aux collects nothing; candidates are returned via the scan ys by
  wrapping this step with collect-all (see value.py)."""

  def step(aux, x, t, t_next, key):
    b, l = x.shape
    sigma_t, _, mct, mcs = _move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, jnp.full((b,), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(key, log_q, x, mask_index, repeats)
    # reference keeps the LAST of the 10 rollouts as x (:849)
    return candidates, candidates[:, -1]

  return step
