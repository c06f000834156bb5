"""Cross-framework END-TO-END decode parity (VERDICT r3 item 2).

The per-module importer tests prove flax == torch for every net; these
tests close the remaining gap: the WHOLE guided algorithm, run
head-to-head. The torch side executes the reference's decode loops
(tests/torch_decode_mirror.py — the line-cited algorithm around a
reference-faithful torch CNNModel, tests/torch_mirrors.py); the jax side
decodes with the SAME weights carried through importers.cnn. RNG streams differ by construction, so the
assertion is the BASELINE.json bar: reward-distribution agreement —
two-sample KS test + quantile tolerances at N=256 per side.

Shared shape: L=16, B=256, steps=8, M=4; value/reward = a fixed linear
motif score implemented identically in numpy/torch/jax so neither side
carries net-import noise into the distribution comparison.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
from scipy import stats as sps

import jax
import jax.numpy as jnp

import torch_decode_mirror as tdm

B, L, STEPS, M = 256, 16, 8, 4
KS_PVAL = 1e-3


def _load_reference_dnaconv():
  import torch_mirrors
  return torch_mirrors


@pytest.fixture(scope='module')
def harness():
  """Build the shared-weight denoiser pair + the linear value/reward."""
  dnaconv = _load_reference_dnaconv()
  args = types.SimpleNamespace(
      clean_data=False, hidden_dim=32, num_cnn_stacks=1, dropout=0.0,
      cls_free_guidance=False)
  torch.manual_seed(7)
  tmodel = dnaconv.CNNModel(args, alphabet_size=5, num_cls=3)
  # sharpen the random denoiser so p(x0|xt) is peaked and the decode
  # dynamics (carry-over, q_xs mass split) actually matter
  with torch.no_grad():
    tmodel.final_conv[2].weight *= 3.0
  tmodel.eval()
  tden = tdm.TorchDenoiser(tmodel, time_conditioning=False)

  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.importers.cnn import import_cnn_params
  cfg = tiny_test_config('rna')
  cfg.model.hidden_dim = 32
  cfg.model.num_cnn_stacks = 1
  cfg.model.length = L
  cfg.sampling.steps = STEPS
  jmodel = Diffusion(cfg, rng=jax.random.key(0))
  sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
  jmodel.variables = import_cnn_params(sd, num_layers=5)

  W = np.random.default_rng(3).normal(size=(L, 4)).astype(np.float32)
  return types.SimpleNamespace(tden=tden, jmodel=jmodel, cfg=cfg, W=W)


def _torch_value(W):
  W_t = torch.tensor(W)

  def fn(x):
    oh = tdm.transform_samples(x) if not x.dtype.is_floating_point else x
    return (oh * W_t).sum(dim=(-1, -2))
  return fn


def _torch_reward(W):
  W_t = torch.tensor(W)
  return lambda oh: (oh * W_t).sum(dim=(-1, -2))


def _jax_reward(W):
  W_j = jnp.asarray(W)
  return lambda oh: (oh * W_j).sum(axis=(-1, -2))


def _rewards_np(tokens, W):
  keep = (np.asarray(tokens) != 4)
  oh = np.eye(4, dtype=np.float32)[np.clip(tokens, 0, 3)] \
      * keep[..., None]
  return (oh * W).sum(axis=(-1, -2))


def _assert_distributions_agree(got, want, label,
                                q_tol_scale: float = 0.35):
  """KS two-sample + q50/q80 agreement, tolerance scaled to the
  pooled spread (the BASELINE.md claim structure)."""
  ks = sps.ks_2samp(got, want)
  scale = max(np.std(np.concatenate([got, want])), 1e-6)
  q_got = np.quantile(got, [0.5, 0.8])
  q_want = np.quantile(want, [0.5, 0.8])
  assert ks.pvalue > KS_PVAL, (
      f'{label}: KS stat {ks.statistic:.3f} p {ks.pvalue:.2g}; '
      f'q50/q80 jax {q_got} vs torch-reference {q_want}')
  np.testing.assert_allclose(
      q_got, q_want, atol=q_tol_scale * scale,
      err_msg=f'{label}: quantile drift (pooled std {scale:.3f})')


def _decode_pair(h, algo, jax_sampler_fn, **mirror_kwargs):
  torch.manual_seed(11)
  np.random.seed(11)
  t_tokens = tdm.decode(h.tden, algo, B, L, STEPS, **mirror_kwargs)
  j_tokens = np.asarray(jax_sampler_fn(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()
  return (_rewards_np(j_tokens, h.W),
          _rewards_np(np.asarray(t_tokens), h.W))


@pytest.fixture(scope='module')
def learned_nets():
  """LEARNED-net fixtures for the in-the-loop e2e tests (VERDICT r4
  item 1): a ConvGRU value net and an Enformer-trunk reward net, built
  in torch at the reference layout (Enformer.py:1337-1426 /
  :1271-1334), weights randomized to non-degenerate values, imported
  into flax through the real checkpoint importers. Both run in eval
  mode with BatchNorm batch stats — the exact composition the
  reference's decode stack executes."""
  import torch_mirrors as tm
  from svdd.importers.convgru import import_convgru_value_model
  from svdd.importers.enformer import import_enformer_value_model
  from svdd.models.convgru import ConvGRUValueModel
  from svdd.models.enformer import EnformerValueModel

  torch.manual_seed(21)
  gru_mirror = tm.make_rna_value_mirror()
  tm.randomize_state_dict(gru_mirror, seed=22)
  gru_mirror.eval()
  gru_vars = import_convgru_value_model(
      {k: v.detach().numpy() for k, v in gru_mirror.state_dict().items()},
      n_conv=6)
  gru_model = ConvGRUValueModel(dropout=0.0)

  torch.manual_seed(23)
  enf_kw = dict(n_conv=3, channels=384, n_transformers=2, n_heads=2,
                key_len=8)
  enf_mirror = tm.make_dna_value_mirror(**enf_kw)
  tm.randomize_state_dict(enf_mirror, seed=24)
  enf_mirror.eval()
  enf_vars = import_enformer_value_model(
      {k: v.detach().numpy() for k, v in enf_mirror.state_dict().items()},
      n_conv=3, n_transformers=2)
  enf_model = EnformerValueModel(n_tasks=1, **enf_kw)
  return types.SimpleNamespace(
      gru_mirror=gru_mirror, gru_model=gru_model, gru_vars=gru_vars,
      enf_mirror=enf_mirror, enf_model=enf_model, enf_vars=enf_vars)


def _torch_net_value(mirror):
  """tokens (or one-hot, for classifier autograd) -> (N,) net score."""

  def fn(x):
    oh = tdm.transform_samples(x) if not x.dtype.is_floating_point else x
    out = mirror(oh)
    while out.ndim > 1:
      out = out.squeeze(-1)
    return out
  return fn


def _torch_net_reward(mirror):
  def fn(oh):
    with torch.no_grad():
      out = mirror(oh)
    while out.ndim > 1:
      out = out.squeeze(-1)
    return out
  return fn


def _jax_net_scorer(model, variables):
  """One shared measurement scorer (jax net on final tokens) applied to
  BOTH frameworks' outputs, so the distribution comparison isolates
  decode dynamics from scorer noise (importer exactness is pinned
  separately at atol 5e-5 in test_importers.py)."""
  from svdd import mdlm
  apply = jax.jit(lambda toks: model.apply(
      variables, mdlm.transform_samples(toks)))
  return lambda tokens: np.asarray(apply(jnp.asarray(tokens)))


def test_svdd_mc_learned_convgru_net_matches_reference(harness,
                                                       learned_nets):
  """SVDD-MC with a LEARNED ConvGRU value net in the loop on both
  sides (the reference composition: guided scan driving a torch net in
  eval mode with batch stats, Enformer.py:399-478 + :1337-1426) —
  closes the r4 harness's linear-probe gap (VERDICT r4 item 1)."""
  h, nets = harness, learned_nets
  from svdd import mdlm
  value_pair = (lambda vars_, toks: nets.gru_model.apply(
      vars_, mdlm.transform_samples(toks)), nets.gru_vars)
  sampler = h.jmodel.controlled_sampler(value_pair, B, sample_M=M,
                                        num_steps=STEPS)
  torch.manual_seed(11)
  np.random.seed(11)
  with torch.no_grad():
    t_tokens = tdm.decode(h.tden, 'mc', B, L, STEPS,
                          value_fn=_torch_net_value(nets.gru_mirror),
                          sample_M=M)
  j_tokens = np.asarray(sampler(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()

  score = _jax_net_scorer(nets.gru_model, nets.gru_vars)
  got, want = score(j_tokens), score(np.asarray(t_tokens))
  _assert_distributions_agree(got, want, 'SVDD-MC learned ConvGRU')
  # the learned net actually steered BOTH decodes: guided outputs score
  # higher under the net than the unguided baseline
  base = score(np.asarray(h.jmodel.sampler(B, num_steps=STEPS)(
      jax.random.key(6)).samples))
  lift = 0.25 * max(np.std(base), 1e-6)
  assert np.median(got) > np.median(base) + lift
  assert np.median(want) > np.median(base) + lift


def test_classifier_learned_convgru_net_matches_reference(harness,
                                                          learned_nets):
  """Classifier guidance differentiating THROUGH the learned ConvGRU
  net (torch autograd vs jax.grad through the imported net) — the
  gradient-path twin of the MC test."""
  h, nets = harness, learned_nets
  value_pair = (lambda vars_, oh: nets.gru_model.apply(vars_, oh),
                nets.gru_vars)
  sampler = h.jmodel.classifier_sampler(value_pair, B,
                                        guidance_scale=50.0,
                                        num_steps=STEPS)
  torch.manual_seed(11)
  np.random.seed(11)
  t_tokens = tdm.decode(h.tden, 'classifier', B, L, STEPS,
                        value_fn=_torch_net_value(nets.gru_mirror),
                        guidance_scale=50.0)
  j_tokens = np.asarray(sampler(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()
  score = _jax_net_scorer(nets.gru_model, nets.gru_vars)
  _assert_distributions_agree(score(j_tokens),
                              score(np.asarray(t_tokens)),
                              'classifier learned ConvGRU')


def test_tds_learned_enformer_reward_matches_reference(harness,
                                                       learned_nets):
  """TDS with the LEARNED Enformer-trunk reward in the Tweedie
  importance weights — run at an alpha with healthy ESS (the learned
  net's score scale differs from the linear probe's), pooled over 3
  runs per side on the run-median statistic (same protocol as
  test_tds_matches_reference)."""
  h, nets = harness, learned_nets
  reward_pair = (lambda vars_, oh: nets.enf_model.apply(vars_, oh),
                 nets.enf_vars)
  alpha = 2.0
  sampler = h.jmodel.tds_sampler(reward_pair, B, alpha=alpha,
                                 num_steps=STEPS)
  score = _jax_net_scorer(nets.enf_model, nets.enf_vars)
  t_medians, j_medians, ess_mins = [], [], []
  for seed in range(3):
    torch.manual_seed(11 + seed)
    np.random.seed(11 + seed)
    with torch.no_grad():
      t_tokens = np.asarray(tdm.decode(
          h.tden, 'tds', B, L, STEPS,
          reward_fn=_torch_net_reward(nets.enf_mirror), alpha=alpha))
    res = sampler(jax.random.key(90 + seed))
    j_tokens = np.asarray(res.samples)
    assert (j_tokens != 4).all() and (t_tokens != 4).all()
    t_medians.append(np.median(score(t_tokens)))
    j_medians.append(np.median(score(j_tokens)))
    ess_mins.append(float(np.asarray(res.extra['ess']).min()))
  spread = max(np.std(t_medians), np.std(j_medians), 1e-3)
  assert abs(np.mean(j_medians) - np.mean(t_medians)) < \
      max(4 * spread, 0.15), (
          f'TDS learned-net medians diverged: jax {j_medians} vs '
          f'torch {t_medians} (ESS mins {ess_mins})')


def test_dps_learned_enformer_reward_matches_reference(harness,
                                                       learned_nets):
  """DPS differentiating through the LEARNED Enformer-trunk reward
  (conv tower + attention pools + transformer + BatchNorm stats in the
  in-scan gradient) — the gradient-path completion of the learned-net
  e2e set."""
  h, nets = harness, learned_nets
  reward_pair = (lambda vars_, oh: nets.enf_model.apply(vars_, oh),
                 nets.enf_vars)
  sampler = h.jmodel.dps_sampler(reward_pair, B, guidance_scale=20.0,
                                 num_steps=STEPS)
  torch.manual_seed(11)
  np.random.seed(11)
  t_tokens = tdm.decode(h.tden, 'dps', B, L, STEPS,
                        reward_fn=_torch_net_value(nets.enf_mirror),
                        guidance_scale=20.0)
  j_tokens = np.asarray(sampler(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()
  score = _jax_net_scorer(nets.enf_model, nets.enf_vars)
  _assert_distributions_agree(score(j_tokens),
                              score(np.asarray(t_tokens)),
                              'DPS learned Enformer')


def test_svdd_pm_learned_enformer_reward_matches_reference(
    harness, learned_nets):
  """SVDD-PM (Tweedie) with a LEARNED Enformer-trunk reward net — the
  reference's PM reward path (Enformer.py:1271-1334 through
  diffusion_gosai.py:1374-1460) with conv tower + attention pools +
  transformer blocks + BatchNorm stats all live in the loop."""
  h, nets = harness, learned_nets
  reward_pair = (lambda vars_, oh: nets.enf_model.apply(vars_, oh),
                 nets.enf_vars)
  sampler = h.jmodel.tweedie_sampler(reward_pair, B, sample_M=M,
                                     tweedie=True, num_steps=STEPS)
  torch.manual_seed(11)
  np.random.seed(11)
  with torch.no_grad():
    t_tokens = tdm.decode(h.tden, 'pm', B, L, STEPS,
                          reward_fn=_torch_net_reward(nets.enf_mirror),
                          sample_M=M, tweedie=True)
  j_tokens = np.asarray(sampler(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()
  score = _jax_net_scorer(nets.enf_model, nets.enf_vars)
  _assert_distributions_agree(score(j_tokens),
                              score(np.asarray(t_tokens)),
                              'SVDD-PM learned Enformer')


def test_baseline_matches_reference(harness):
  h = harness
  sampler = h.jmodel.sampler(B, num_steps=STEPS)
  got, want = _decode_pair(h, 'baseline', sampler)
  _assert_distributions_agree(got, want, 'uncontrolled ddpm')


def test_svdd_mc_matches_reference(harness):
  h = harness
  W_j = jnp.asarray(h.W)
  from svdd import mdlm
  value_tok = lambda toks: (mdlm.transform_samples(toks)
                            * W_j).sum(axis=(-1, -2))
  sampler = h.jmodel.controlled_sampler(value_tok, B, sample_M=M,
                                        num_steps=STEPS)
  got, want = _decode_pair(h, 'mc', sampler, value_fn=_torch_value(h.W),
                           sample_M=M)
  base = _rewards_np(
      np.asarray(h.jmodel.sampler(B, num_steps=STEPS)(
          jax.random.key(6)).samples), h.W)
  _assert_distributions_agree(got, want, 'SVDD-MC')
  # and the guidance actually moved the distribution on BOTH sides
  assert np.median(got) > np.median(base) + 0.5
  assert np.median(want) > np.median(base) + 0.5


def test_svdd_mc_scheduled_m_matches_reference(harness):
  """Scheduled-M SVDD-MC cross-framework: both sides run the same
  per-phase candidate schedule (here 4 steps at M=2, 4 at M=4) — the
  phased scan must stay distribution-identical to the reference loop
  with per-step M."""
  h = harness
  W_j = jnp.asarray(h.W)
  from svdd import mdlm
  value_tok = lambda toks: (mdlm.transform_samples(toks)
                            * W_j).sum(axis=(-1, -2))
  sched = ((STEPS // 2, 2), (STEPS - STEPS // 2, M))
  sampler = h.jmodel.controlled_sampler(value_tok, B,
                                        m_schedule=sched,
                                        num_steps=STEPS)
  got, want = _decode_pair(h, 'mc', sampler, value_fn=_torch_value(h.W),
                           m_schedule=list(sched))
  _assert_distributions_agree(got, want, 'SVDD-MC scheduled-M')


def test_svdd_pm_tweedie_matches_reference(harness):
  h = harness
  sampler = h.jmodel.tweedie_sampler(_jax_reward(h.W), B, sample_M=M,
                                     tweedie=True, num_steps=STEPS)
  got, want = _decode_pair(h, 'pm', sampler,
                           reward_fn=_torch_reward(h.W),
                           sample_M=M, tweedie=True)
  _assert_distributions_agree(got, want, 'SVDD-PM tweedie')


def test_svdd_pm_heuristic_matches_reference(harness):
  h = harness
  sampler = h.jmodel.tweedie_sampler(_jax_reward(h.W), B, sample_M=M,
                                     tweedie=False, num_steps=STEPS)
  got, want = _decode_pair(h, 'pm', sampler,
                           reward_fn=_torch_reward(h.W),
                           sample_M=M, tweedie=False)
  _assert_distributions_agree(got, want, 'SVDD-PM heuristic')


def test_tds_matches_reference(harness):
  """TDS needs special statistical handling: systematic resampling
  CORRELATES the particles (bootstrap ancestry), so a single run's
  empirical distribution is high-variance — at the reference's
  alpha=0.5 with this reward scale the batch degenerates to ESS~1 and
  even two reference runs disagree wildly. Compare at an alpha with
  healthy ESS, pooled over 4 independent runs per side, on the
  run-median statistic."""
  h = harness
  alpha = 5.0
  sampler = h.jmodel.tds_sampler(_jax_reward(h.W), B, alpha=alpha,
                                 num_steps=STEPS)
  t_medians, j_medians = [], []
  pooled_t, pooled_j = [], []
  for seed in range(4):
    torch.manual_seed(11 + seed)
    np.random.seed(11 + seed)
    t_tokens = np.asarray(tdm.decode(
        h.tden, 'tds', B, L, STEPS, reward_fn=_torch_reward(h.W),
        alpha=alpha))
    j_tokens = np.asarray(sampler(jax.random.key(50 + seed)).samples)
    assert (j_tokens != 4).all() and (t_tokens != 4).all()
    rt, rj = _rewards_np(t_tokens, h.W), _rewards_np(j_tokens, h.W)
    t_medians.append(np.median(rt))
    j_medians.append(np.median(rj))
    pooled_t.append(rt)
    pooled_j.append(rj)
  # run-median agreement (within-framework seed spread is ~0.6-1.5
  # here; the two frameworks' per-seed medians interleave)
  assert abs(np.mean(j_medians) - np.mean(t_medians)) < 1.2, (
      f'TDS medians diverged: jax {j_medians} vs torch {t_medians}')
  ks = sps.ks_2samp(np.concatenate(pooled_j), np.concatenate(pooled_t))
  assert ks.statistic < 0.15, (
      f'TDS pooled KS stat {ks.statistic:.3f} '
      f'(jax medians {j_medians} vs torch {t_medians})')
  # guidance moved both sides above their (shared) baseline
  base = _rewards_np(
      np.asarray(h.jmodel.sampler(B, num_steps=STEPS)(
          jax.random.key(6)).samples), h.W)
  assert np.mean(j_medians) > np.median(base) + 1.0
  assert np.mean(t_medians) > np.median(base) + 1.0


def test_tds_alpha05_matched_degeneracy(harness):
  """TDS at the reference's PUBLISHED operating point alpha=0.5
  (reference anoter_README.md:1): with this reward scale the
  importance weights collapse and the resampled batch degenerates to a
  handful of ancestor lineages on BOTH frameworks — the matched
  failure mode, asserted directly (VERDICT r4 item 3). Our side
  additionally surfaces the collapse through the in-scan ESS
  telemetry that the reference lacks."""
  h = harness
  alpha = 0.5
  sampler = h.jmodel.tds_sampler(_jax_reward(h.W), B, alpha=alpha,
                                 num_steps=STEPS)
  j_unique, t_unique, min_ess = [], [], []
  for seed in range(3):
    torch.manual_seed(11 + seed)
    np.random.seed(11 + seed)
    t_tokens = np.asarray(tdm.decode(
        h.tden, 'tds', B, L, STEPS, reward_fn=_torch_reward(h.W),
        alpha=alpha))
    res = sampler(jax.random.key(70 + seed))
    j_tokens = np.asarray(res.samples)
    assert (j_tokens != 4).all() and (t_tokens != 4).all()
    j_unique.append(len(np.unique(j_tokens, axis=0)))
    t_unique.append(len(np.unique(t_tokens, axis=0)))
    min_ess.append(float(np.asarray(res.extra['ess']).min()))
  # both frameworks collapse: the 256-particle batch carries only a
  # few distinct lineages (an uncontrolled baseline has ~B unique rows)
  assert max(j_unique) < B // 4, f'jax did not degenerate: {j_unique}'
  assert max(t_unique) < B // 4, f'torch did not degenerate: {t_unique}'
  # and the telemetry SHOWS it: ESS collapses near 1 at some step
  assert max(min_ess) < 4.0, f'ESS telemetry missed collapse: {min_ess}'
  # degeneracy magnitude agrees across frameworks (same failure mode,
  # not merely both-broken-differently): unique-lineage counts within
  # a small factor
  assert max(max(j_unique), max(t_unique)) <= \
      8 * max(1, min(min(j_unique), min(t_unique))), (
          f'degeneracy mismatch: jax {j_unique} vs torch {t_unique}')


def test_dps_matches_reference(harness):
  h = harness
  sampler = h.jmodel.dps_sampler(_jax_reward(h.W), B,
                                 guidance_scale=2.0, num_steps=STEPS)
  got, want = _decode_pair(h, 'dps', sampler,
                           reward_fn=_torch_reward(h.W),
                           guidance_scale=2.0)
  _assert_distributions_agree(got, want, 'DPS')


def test_classifier_matches_reference(harness):
  h = harness
  sampler = h.jmodel.classifier_sampler(_jax_reward(h.W), B,
                                        guidance_scale=2.0,
                                        num_steps=STEPS)
  got, want = _decode_pair(h, 'classifier', sampler,
                           value_fn=_torch_value(h.W),
                           guidance_scale=2.0)
  _assert_distributions_agree(got, want, 'classifier guidance')


def test_analytic_sampler_matches_reference(harness):
  """The analytic (score-based) sampler: pins get_score /
  staggered_score / transp_transition semantics end-to-end across
  frameworks (diffusion_gosai.py:1581-1658)."""
  h = harness
  cfg = h.cfg.override()
  cfg.sampling.predictor = 'analytic'
  from svdd.diffusion import Diffusion
  jm = Diffusion(cfg, rng=jax.random.key(0))
  jm.variables = h.jmodel.variables
  sampler = jm.sampler(B, num_steps=STEPS)

  torch.manual_seed(11)
  t_tokens = tdm.decode_analytic(h.tden, B, L, STEPS)
  j_tokens = np.asarray(sampler(jax.random.key(5)).samples)
  assert (j_tokens != 4).all() and (np.asarray(t_tokens) != 4).all()
  _assert_distributions_agree(_rewards_np(j_tokens, h.W),
                              _rewards_np(np.asarray(t_tokens), h.W),
                              'analytic sampler')


def _mid_state(batch=6):
  """A deterministic partially-masked state."""
  torch.manual_seed(3)
  x_t = torch.randint(0, 5, (batch, L))
  return x_t, jnp.asarray(x_t.numpy())


def test_dps_gradient_exact_parity(harness):
  """DETERMINISTIC cross-framework check of the DPS gradient (the
  SURVEY §7.3 'easy to get subtly wrong' semantics: grad wrt the FULL
  5-channel one-hot through forward2 + copy-merge + softmax, then
  mask-column recentering): torch autograd through the reference's
  CNNModel.forward2 must equal jax.grad through the imported flax
  forward_onehot, elementwise."""
  import torch.nn.functional as F
  h = harness
  x_t, x_j = _mid_state()
  b = x_t.shape[0]
  sigma_s = tdm.loglinear_sigma(0.4)
  W_t, W_j = torch.tensor(h.W), jnp.asarray(h.W)

  # torch side (mirror of compute_gradient_DPS, diffusion_gosai.py:1321)
  x_onehot = F.one_hot(x_t, 5).float().requires_grad_(True)
  copy = (x_t != 4).float()[..., None]
  expected = h.tden.forward2(x_onehot, x_t, sigma_s)
  expected = copy * x_onehot + (1 - copy) * expected
  probs = expected.softmax(dim=-1)
  (probs[..., :4] * W_t).sum(dim=(-1, -2)).mean().backward()
  want = x_onehot.grad.numpy()

  # jax side (guidance.dps_step's score_mean)
  copy_j = (x_j != 4).astype(jnp.float32)[..., None]
  sigma_b = jnp.full((b,), sigma_s)

  def score_mean(oh):
    exp_j = h.jmodel.forward_onehot(h.jmodel.variables, oh, x_j,
                                    sigma_b)
    exp_j = copy_j * oh + (1 - copy_j) * exp_j
    p = jax.nn.softmax(exp_j, axis=-1)
    return ((p[..., :4] * W_j).sum(axis=(-1, -2))).mean()

  got = np.asarray(jax.grad(score_mean)(
      jax.nn.one_hot(x_j, 5, dtype=jnp.float32)))
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_tds_ratio_components_exact_parity(harness):
  """DETERMINISTIC cross-framework check of the TDS importance-weight
  pieces: reward_num / reward_den (tweedie posterior onehots at
  sigma_s) computed on the same (x, sample) pair agree elementwise
  (diffusion_gosai.py:1260-1281)."""
  from svdd.sampling import guidance as G
  h = harness
  x_t, x_j = _mid_state()
  b = x_t.shape[0]
  sigma_s = tdm.loglinear_sigma(0.3)
  torch.manual_seed(4)
  sample_t = torch.where(x_t != 4, x_t,
                         torch.randint(0, 4, x_t.shape))
  sample_j = jnp.asarray(sample_t.numpy())
  W_t = torch.tensor(h.W)

  num_t = ((tdm._posterior_onehot(h.tden.forward(sample_t, sigma_s),
                                  sample_t) * W_t)
           .sum(dim=(-1, -2)).numpy())
  den_t = ((tdm._posterior_onehot(h.tden.forward(x_t, sigma_s), x_t)
            * W_t).sum(dim=(-1, -2)).numpy())

  den_fn = lambda xx, ss: h.jmodel.forward(h.jmodel.variables, xx, ss)
  sigma_b = jnp.full((b,), sigma_s)
  rj = _jax_reward(h.W)
  num_j = np.asarray(rj(G._posterior_onehot(
      den_fn(sample_j, sigma_b), sample_j, 4)))
  den_j = np.asarray(rj(G._tweedie_posterior_onehot(
      den_fn, x_j, sigma_b, 4)))
  np.testing.assert_allclose(num_j, num_t, atol=1e-4, rtol=1e-4)
  np.testing.assert_allclose(den_j, den_t, atol=1e-4, rtol=1e-4)


def test_q_xs_exact_parity(harness):
  """DETERMINISTIC check of the reverse-transition density q_xs on the
  same state: mirror probs == exp of our log_q (diffusion_gosai.py:
  1185-1197 vs mdlm.log_q_xs)."""
  from svdd import mdlm
  h = harness
  x_t, x_j = _mid_state()
  t, t_next = 0.6, 0.5
  sigma_t, sigma_s, mct, mcs = tdm._move_chances(t, t_next)
  q_t = tdm._q_xs(h.tden.forward(x_t, sigma_t), mct, mcs).numpy()
  log_p_j = h.jmodel.forward(h.jmodel.variables, x_j,
                             jnp.full((x_t.shape[0],), sigma_t))
  q_j = np.asarray(jnp.exp(mdlm.log_q_xs(log_p_j, mct, mcs, 4)))
  np.testing.assert_allclose(q_j, q_t, atol=1e-5, rtol=1e-4)
