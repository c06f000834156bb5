"""Reward-guided decode pipelines (the flagship entry path).

Rebuild of the reference's BaseModel.controlled_decode* drivers
(reference Enformer.py:399-813) and the shared decode-CLI
scaffold (decode.py:52-119): run guided sampling, score the outputs
with both the value net and the reward oracle, generate the unguided
baseline + best-of-N comparison, and emit ``log/{task}-{reward}.npz``
with ``decoding``/``baseline`` keys bit-compatible with the reference's
output files (decode.py:117).

Each of gen_batch_num guided batches is one jitted scan
invocation; the baseline's gen_batch_num*sample_M unguided batches fold
into fewer, larger batches when memory allows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from svdd import mdlm, utils
from svdd.diffusion import Diffusion

LOGGER = utils.get_logger(__name__)


@dataclasses.dataclass
class DecodeResult:
  """Mirrors controlled_decode's return tuple (Enformer.py:478)."""
  samples: np.ndarray          # (N, L) guided tokens
  value_preds: np.ndarray      # (N,) value-net scores of guided seqs
  reward_preds: np.ndarray     # (N,) oracle scores of guided seqs
  top_k: np.ndarray            # best-of-N baseline scores
  baseline_preds: np.ndarray   # (N,) unguided oracle scores
  diagnostics: Optional[dict] = None   # e.g. TDS per-step ESS traces

  def save_npz(self, path: str) -> None:
    """decode.py:117 format: keys 'decoding' and 'baseline'."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path, decoding=self.reward_preds,
             baseline=self.baseline_preds)


def _as_callable(fn_or_pair):
  """Accept plain callables or hoisted (apply_fn, variables) pairs
  (Diffusion._hoist convention)."""
  if isinstance(fn_or_pair, tuple):
    apply_fn, variables = fn_or_pair
    return lambda *args: apply_fn(variables, *args)
  return fn_or_pair


def _score(reward_fn, samples, task: str = 'dna',
           saluki_body=None, saluki_final_length: int = 12288
           ) -> np.ndarray:
  """Oracle score of token samples; rna_saluki routes through the
  12288x6 saluki input builder (Enformer.py:279-316)."""
  if task == 'rna_saluki':
    onehot = mdlm.transform_samples_saluki(
        samples, saluki_body, final_length=saluki_final_length)
  else:
    onehot = mdlm.transform_samples(samples)
  return np.asarray(_as_callable(reward_fn)(onehot))


def _baseline(diffusion: Diffusion, reward_fn, batch_size: int,
              gen_batch_num: int, sample_M: int, key: jax.Array,
              skip_best_of_n: bool = False, task: str = 'dna',
              saluki_body=None, saluki_final_length: int = 12288):
  """Unguided baseline + best-of-N (Enformer.py:456-476): draw
  gen_batch_num*sample_M batches worth of sequences, keep the first
  gen_batch_num*batch_size as the baseline distribution,
  top-k(all, N/sample_M) as best-of-N.

  The reference runs these as sample_M*gen_batch_num SEQUENTIAL
  full decodes; here they fold into max-size batched sampler calls
  (the unguided decode is denoiser-only — far lighter than the guided
  step that already runs B*M through the value net — so a much larger
  batch fits). One compile, ~sample_M x fewer scan invocations."""
  total = (gen_batch_num if skip_best_of_n
           else gen_batch_num * sample_M) * batch_size
  fold_cap = int(os.environ.get('SVDD_BASELINE_MAX_BATCH', '4096'))
  # balance the fold: a fixed cap-sized fold over-generated up to
  # big-1 wasted rows on the last call (flagship shape: total=5120,
  # cap 4096 -> 2x4096 = 60% waste); ceil-split wastes < n_calls rows
  n_calls = max(1, -(-total // fold_cap))
  big = -(-total // n_calls)
  sampler = diffusion.sampler(big)
  all_preds = []
  for i in range(n_calls):
    key, sub = jax.random.split(key)
    res = sampler(sub)
    all_preds.append(_score(reward_fn, res.samples, task,
                            saluki_body, saluki_final_length))
  all_preds = np.concatenate(all_preds)[:total]
  baseline = all_preds[:gen_batch_num * batch_size]
  k = max(1, len(all_preds) // sample_M)
  top_k = np.sort(all_preds)[-k:][::-1].copy()
  return baseline, top_k


def _maybe_aot_cache(sampler, diffusion: Diffusion, algo: str,
                     batch_size: int, sample_M: int,
                     hyper: dict | None = None):
  """SVDD_AOT_CACHE=<dir>: serve the guided sampler from a compiled
  XLA executable artifact (svdd.aot). First run compiles once,
  exports, and serves from the artifact; later processes load in
  seconds with NO compile. Keyed by algo/shape/backend + a hash of
  (config, sampler hyperparameters, aot.PROGRAM_ENV switches,
  jax version) — everything baked into the traced program. Denoiser
  weights stay call arguments, so new diffusion checkpoints reuse the
  artifact; value/reward weights do too when passed as
  (apply_fn, variables) pairs (the CLI norm). A plain-closure
  value_fn bakes its weights into the artifact as constants — warned
  below, because a retrained net would silently be ignored on a
  cache hit."""
  cache_dir = os.environ.get('SVDD_AOT_CACHE')
  if not cache_dir:
    return sampler
  import hashlib

  from svdd import aot
  key_src = repr((repr(diffusion.config), hyper or {}, aot.program_env(),
                  jax.__version__, aot.PROGRAM_REV))
  cfg_hash = hashlib.sha1(key_src.encode()).hexdigest()[:10]
  name = (f'{algo}-b{batch_size}-m{sample_M}'
          f'-{jax.default_backend()}-{cfg_hash}.svddc')
  path = os.path.join(cache_dir, name)
  den_vars, extra_vars = sampler.default_args
  if algo != 'none' and not jax.tree.leaves(extra_vars):
    LOGGER.warning(
        'SVDD_AOT_CACHE: value/reward fn is a plain closure — its '
        'weights are baked into the artifact as constants and a '
        'retrained net will NOT take effect on a cache hit. Pass '
        '(apply_fn, variables) to keep weights as call arguments.')
  if not os.path.exists(path):
    os.makedirs(cache_dir, exist_ok=True)
    size = aot.export_compiled(sampler, path)
    LOGGER.info('AOT sampler exported to %s (%.1f MB)', path,
                size / 1e6)
  # serve from the artifact either way: an explicit lower().compile()
  # does not seed the jit dispatch cache, so returning the live
  # sampler after exporting would re-trace and re-compile on first use
  call = aot.load_compiled(path)
  LOGGER.info('AOT sampler loaded from %s (no compile)', path)

  class _Loaded:
    default_args = (den_vars, extra_vars)

    def __call__(self, key, variables=None):
      return call(den_vars if variables is None else variables,
                  extra_vars, key)

  return _Loaded()


def run_decode(
    diffusion: Diffusion,
    reward_fn: Callable,
    *,
    algo: str = 'svdd_mc',
    value_fn: Optional[Callable] = None,
    gen_batch_num: int = 1,
    batch_size: int = 256,
    sample_M: int = 10,
    alpha: float = 1.0,
    guidance_scale: float = 1.0,
    tweedie: bool = True,
    seed: int = 44,
    skip_best_of_n: bool = False,
    ess_threshold: Optional[float] = None,
    m_schedule=None,
    task: str = 'dna',
    saluki_body=None,
    saluki_final_length: int = 12288,
) -> DecodeResult:
  """One controlled_decode run (Enformer.py:399-478 and variants).

  algo: svdd_mc | svdd_pm | tds | dps | classifier | none
  """
  key = jax.random.key(seed)
  key, guided_key, base_key = jax.random.split(key, 3)

  if algo == 'svdd_mc':
    if value_fn is None:
      raise ValueError('svdd_mc needs a value_fn')
    sampler = diffusion.controlled_sampler(value_fn, batch_size,
                                           sample_M=sample_M,
                                           m_schedule=m_schedule)
  elif algo == 'svdd_pm':
    sampler = diffusion.tweedie_sampler(
        reward_fn, batch_size, sample_M=sample_M, tweedie=tweedie,
        task=task, saluki_body=saluki_body,
        saluki_final_length=saluki_final_length,
        m_schedule=m_schedule)
  elif algo == 'tds':
    sampler = diffusion.tds_sampler(reward_fn, batch_size, alpha=alpha,
                                    ess_threshold=ess_threshold)
  elif algo == 'dps':
    sampler = diffusion.dps_sampler(reward_fn, batch_size,
                                    guidance_scale=guidance_scale)
  elif algo == 'classifier':
    if value_fn is None:
      raise ValueError('classifier guidance needs a value_fn (one-hot)')
    sampler = diffusion.classifier_sampler(value_fn, batch_size,
                                           guidance_scale=guidance_scale)
  elif algo == 'none':
    sampler = diffusion.sampler(batch_size)
  else:
    raise ValueError(f'unknown algo {algo!r}')
  # saluki_body's VALUES are baked into the traced program as
  # constants, so they must key the artifact too (sha1: python hash()
  # is salted per-process and would never hit the cache)
  if saluki_body is None:
    saluki_sig = None
  else:
    import hashlib
    saluki_sig = hashlib.sha1(
        np.asarray(saluki_body, np.float32).tobytes()).hexdigest()[:10]
  sampler = _maybe_aot_cache(
      sampler, diffusion, algo, batch_size, sample_M,
      hyper=dict(alpha=alpha, guidance_scale=guidance_scale,
                 ess_threshold=ess_threshold,
                 m_schedule=None if m_schedule is None
                 else tuple(map(tuple, m_schedule)),
                 tweedie=tweedie, task=task,
                 saluki_final_length=saluki_final_length,
                 saluki_sig=saluki_sig))

  samples, value_preds, reward_preds, ess_traces = [], [], [], []
  for i in range(gen_batch_num):
    guided_key, sub = jax.random.split(guided_key)
    res = sampler(sub)
    samples.append(np.asarray(res.samples))
    reward_preds.append(_score(reward_fn, res.samples, task,
                               saluki_body, saluki_final_length))
    if value_fn is not None and algo in ('svdd_mc',):
      value_preds.append(np.asarray(_as_callable(value_fn)(res.samples)))
    else:
      value_preds.append(reward_preds[-1])
    if algo == 'tds' and isinstance(res.extra, dict) \
        and 'ess' in res.extra:
      ess_traces.append(np.asarray(res.extra['ess']))
  LOGGER.info('Value-weighted sampling done.')

  diagnostics = None
  if ess_traces:
    ess = np.stack(ess_traces)                    # (batches, num_steps)
    diagnostics = {'ess': ess,
                   'ess_min': float(ess.min()),
                   'ess_median': float(np.median(ess)),
                   'ess_final': float(ess[:, -1].mean())}
    LOGGER.info('TDS ESS: min %.1f / median %.1f / final %.1f '
                '(B=%d particles)', diagnostics['ess_min'],
                diagnostics['ess_median'], diagnostics['ess_final'],
                batch_size)
    if diagnostics['ess_median'] < 0.05 * batch_size:
      LOGGER.warning(
          'TDS particle set is DEGENERATE (median ESS %.1f of B=%d): '
          'the resampled batch is dominated by a handful of ancestors '
          'and the output distribution is unreliable. Raise --alpha or '
          'enable adaptive resampling with --ess_threshold (e.g. 0.5).',
          diagnostics['ess_median'], batch_size)

  baseline, top_k = _baseline(diffusion, reward_fn, batch_size,
                              gen_batch_num, sample_M, base_key,
                              skip_best_of_n, task, saluki_body,
                              saluki_final_length)
  LOGGER.info('Baseline sampling done.')

  return DecodeResult(
      samples=np.concatenate(samples),
      value_preds=np.concatenate(value_preds),
      reward_preds=np.concatenate(reward_preds),
      top_k=top_k,
      baseline_preds=baseline,
      diagnostics=diagnostics,
  )
