"""Guided-decode QUALITY regression gates (VERDICT r2 item 3).

Two layers:

1. ``test_guided_ordering_midscale`` — runs real guided decodes at a
   mid scale (B=64, steps=32, M=4; far bigger than test_sampler's
   toys) with a deterministic differentiable oracle standing in for
   both reward and value net, and asserts the reference's core
   quality claim (BASELINE.md table; reference log/*.npz):

       baseline q50  <  best-of-N q50  and
       baseline q50  <  SVDD-MC q50   and
       baseline q50  <  SVDD-PM q50

   A kernel/layout change that silently breaks guided selection at
   realistic shapes fails HERE, in CI, instead of in a human reading
   PARITY.md.

2. ``test_demo_artifact_ordering`` — pins the ordering on the
   committed hardware-run demo artifacts (log/demo-rna-MRL*.npz from
   scripts/demo_rna_pipeline.py, trained tiny nets), the
   shape-faithful analogue of the reference's published quantiles.
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _q50(x) -> float:
  return float(np.quantile(np.asarray(x), 0.5))


def test_guided_ordering_midscale():
  import jax

  from svdd import mdlm, rewards
  from svdd.config import tiny_test_config
  from svdd.decode import run_decode
  from svdd.diffusion import Diffusion

  cfg = tiny_test_config('rna')
  cfg.sampling.steps = 32
  cfg.model.length = 16
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  value_fn = lambda tok: reward_fn(mdlm.transform_samples(tok))

  B, M = 64, 4
  mc_lifts, pm_lifts, bons, bases = [], [], [], []
  for seed in (11, 12, 13):
    mc = run_decode(model, reward_fn, algo='svdd_mc',
                    value_fn=value_fn, gen_batch_num=1, batch_size=B,
                    sample_M=M, seed=seed)
    pm = run_decode(model, reward_fn, algo='svdd_pm', gen_batch_num=1,
                    batch_size=B, sample_M=M, seed=seed,
                    skip_best_of_n=True)
    base = _q50(mc.baseline_preds)
    bases.append(base)
    mc_lifts.append(_q50(mc.reward_preds) - base)
    pm_lifts.append(_q50(pm.reward_preds) - base)
    bons.append(_q50(mc.top_k) - base)

  mc_lift, pm_lift = float(np.mean(mc_lifts)), float(np.mean(pm_lifts))
  # REGRESSION-PINNED lift bands (VERDICT r3 item 6): the current code
  # measures mean-of-3-seed q50 lifts MC ~0.52, PM ~0.13 (per-seed
  # spread ±0.06). The bands catch quality degradation — a kernel
  # change that halves the MC lift fails the lower bound — while the
  # upper bound flags a broken-oracle/eval change inflating scores.
  assert 0.30 < mc_lift < 0.80, (bases, mc_lifts)
  assert 0.06 < pm_lift < 0.30, (bases, pm_lifts)
  # best-of-N must clear baseline (it is an order statistic of the
  # SAME distribution; below-baseline means the fold/top-k broke)
  assert np.mean(bons) > 0, (bases, bons)


def test_demo_artifact_ordering():
  """The committed hardware demo npz artifacts must show the
  reference's ordering (BASELINE.md: baseline < best-of-N < SVDD)
  AND a pinned minimum lift (VERDICT r3 weak #3: ordering-only waves
  through a 30% degradation) — the committed RNA run measured
  baseline q50 0.01 / MC 6.84 / PM 9.51, so a refreshed artifact with
  less than half that lift fails here. Regenerate with
  scripts/demo_rna_pipeline.py."""
  mc_path = os.path.join(REPO, 'log', 'demo-rna-MRL.npz')
  pm_path = os.path.join(REPO, 'log', 'demo-rna-MRL_tw.npz')
  if not (os.path.exists(mc_path) and os.path.exists(pm_path)):
    pytest.skip('demo artifacts not present (run '
                'scripts/demo_rna_pipeline.py on hardware)')
  mc = np.load(mc_path)
  pm = np.load(pm_path)
  base = _q50(mc['baseline'])
  assert _q50(mc['decoding']) > base + 3.5, (base, _q50(mc['decoding']))
  assert _q50(pm['decoding']) > base + 5.0, (base, _q50(pm['decoding']))


def test_demo_artifact_ordering_dna():
  """Pooled gate over the COMMITTED independent DNA demo runs
  (VERDICT r4 weak #6: the single-run band was coarse enough to hide
  a ~30% regression). Committed hardware runs and their q50 lifts
  over each run's own baseline:
    run 1 (r4, log/demo_dna_pipeline.json):      MC 12.41, PM 9.51
    run 2 (r5, .run2, seed_offset 100):          MC 11.12, PM 7.75
    run 3 (r5, .run3, seed_offset 200):          MC  9.34, PM 7.49
  Pooled means: MC 10.96, PM 8.25 (run-to-run spread ~±13%; pooling
  3 runs cuts the mean's noise to ~±8%). Bands = pooled mean
  -30%/+40%, so a 30% lift regression FAILS while honest spread
  passes. Regenerate with scripts/demo_dna_pipeline.py
  [--suffix .runN --seed_offset 100*N]."""
  runs = []
  for suffix in ('', '.run2', '.run3'):
    mc_path = os.path.join(REPO, 'log', f'demo-dna-HepG2{suffix}.npz')
    pm_path = os.path.join(REPO, 'log', f'demo-dna-HepG2_tw{suffix}.npz')
    if os.path.exists(mc_path) and os.path.exists(pm_path):
      runs.append((np.load(mc_path), np.load(pm_path)))
  if not runs:
    pytest.skip('DNA demo artifacts not present (run '
                'scripts/demo_dna_pipeline.py on hardware)')
  mc_lifts = [_q50(mc['decoding']) - _q50(mc['baseline'])
              for mc, _ in runs]
  pm_lifts = [_q50(pm['decoding']) - _q50(mc['baseline'])
              for mc, pm in runs]
  mc_lift, pm_lift = float(np.mean(mc_lifts)), float(np.mean(pm_lifts))
  assert 0.7 * 10.96 < mc_lift < 1.4 * 10.96, (mc_lifts, pm_lifts)
  assert 0.7 * 8.25 < pm_lift < 1.4 * 8.25, (mc_lifts, pm_lifts)


def test_demo_artifact_scheduled_m_dna():
  """Scheduled-M quality gate under TRAINED nets (VERDICT r4 item 2):
  the committed run-2 artifacts decode SVDD-MC with the equal-cost
  front-loaded 96:12,32:4 schedule alongside constant M=10 — the
  scheduled lift must stay within 15% of the same run's constM10 lift
  (measured: 11.00 vs 11.25 q50, a 2% gap)."""
  mc_path = os.path.join(REPO, 'log', 'demo-dna-HepG2.run2.npz')
  sched_path = os.path.join(REPO, 'log',
                            'demo-dna-HepG2_sched.run2.npz')
  if not (os.path.exists(mc_path) and os.path.exists(sched_path)):
    pytest.skip('scheduled-M demo artifacts not present')
  mc = np.load(mc_path)
  sched = np.load(sched_path)
  base = _q50(mc['baseline'])
  mc_lift = _q50(mc['decoding']) - base
  sched_lift = _q50(sched['decoding']) - base
  assert sched_lift > 0.85 * mc_lift, (mc_lift, sched_lift)
