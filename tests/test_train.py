"""Training loops: diffusion loss goes down; value net learns the
reward; checkpoint round-trips with iterator state."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd import rewards, value as value_lib
from svdd.config import tiny_test_config
from svdd.data.gosai import FaultTolerantIterator, GosaiDataset
from svdd.diffusion import Diffusion
from svdd.train import diffusion as train_diff
from svdd.train import value as train_val


@pytest.fixture(scope='module')
def cfg():
  c = tiny_test_config('rna')
  c.optim.warmup_steps = 2
  c.optim.lr = 1e-3
  return c


def test_diffusion_loss_decreases(cfg):
  model = Diffusion(cfg, rng=jax.random.key(0))
  ds = GosaiDataset('train', length=cfg.model.length)
  it = iter(FaultTolerantIterator(ds, 8, seed=0))
  trainer = train_diff.Trainer(model, cfg)
  state = trainer.init_or_restore(jax.random.key(1))
  losses = []
  for i in range(30):
    batch = {k: jnp.asarray(v) for k, v in next(it).items()}
    state, loss = trainer.train_step(state, batch)
    losses.append(float(loss))
  assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_ar_loss_matches_hand_computed():
  """parameterization='ar': shifted next-token NLL with NO diffusion
  weighting (diffusion_gosai.py:1671-1697, 1763-1767). Pins the
  gather/shift/mask wiring against an explicit numpy recomputation."""
  cfg = tiny_test_config('rna')
  cfg.backbone = 'ar'
  cfg.parameterization = 'ar'
  model = Diffusion(cfg, rng=jax.random.key(0))
  rng = np.random.default_rng(0)
  b, l = 4, cfg.model.length
  x0 = jnp.asarray(rng.integers(0, 4, (b, l)), jnp.int32)
  mask = jnp.asarray(rng.integers(0, 2, (b, l)).astype(np.float32))
  out = model.loss(model.variables, jax.random.key(1), x0,
                   attention_mask=mask)

  logprobs = np.asarray(model.backbone.apply(
      model.variables, x0[:, :-1], None))
  expect_nll = np.zeros((b, l - 1))
  for i in range(b):
    for j in range(l - 1):
      expect_nll[i, j] = -logprobs[i, j, int(x0[i, j + 1])]
  m = np.asarray(mask)[:, 1:]
  expect = (expect_nll * m).sum() / m.sum()
  np.testing.assert_allclose(float(out.loss), expect, rtol=1e-5)
  np.testing.assert_allclose(np.asarray(out.nlls), expect_nll * m,
                             rtol=1e-5)
  # the diffusion machinery must NOT touch the result: loss is
  # independent of the sampling key (no t-draw, no q_xt masking)
  out2 = model.loss(model.variables, jax.random.key(99), x0,
                    attention_mask=mask)
  assert float(out.loss) == float(out2.loss)


def test_ar_train_step_decreases_loss():
  """An AR train step runs through the standard diffusion Trainer."""
  cfg = tiny_test_config('rna')
  cfg.backbone = 'ar'
  cfg.parameterization = 'ar'
  cfg.optim.warmup_steps = 2
  cfg.optim.lr = 1e-3
  model = Diffusion(cfg, rng=jax.random.key(0))
  ds = GosaiDataset('train', length=cfg.model.length)
  it = iter(FaultTolerantIterator(ds, 8, seed=0))
  trainer = train_diff.Trainer(model, cfg)
  state = trainer.init_or_restore(jax.random.key(1))
  losses = []
  for i in range(20):
    batch = {k: jnp.asarray(v) for k, v in next(it).items()}
    state, loss = trainer.train_step(state, batch)
    losses.append(float(loss))
  assert np.isfinite(losses).all()
  assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_value_training_learns_reward(cfg):
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  vf = value_lib.ValueFunction.create('rna', cfg.model.length,
                                      jax.random.key(2))
  tcfg = train_val.ValueTrainerConfig(batch_size=4, learning_rate=1e-3)
  trainer = train_val.ValueTrainer(model, vf, reward_fn, tcfg)
  state = trainer.init_state(jax.random.key(3))
  state, loss0 = trainer._train_step(state, None)
  for _ in range(15):
    state, loss = trainer._train_step(state, None)
  assert float(loss) < float(loss0)


def test_cdq_training_runs(cfg):
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  vf = value_lib.ValueFunction.create('rna', cfg.model.length,
                                      jax.random.key(2))
  tcfg = train_val.ValueTrainerConfig(batch_size=2, cdq=True)
  trainer = train_val.ValueTrainer(model, vf, reward_fn, tcfg)
  state = trainer.init_state(jax.random.key(3))
  state, loss = trainer._train_step(state, None)
  assert np.isfinite(float(loss))


def test_multisep_training_converges(cfg):
  from svdd.models.multisep import MultiSepValueModel
  from svdd.models.convgru import ConvGRUValueModel
  model = Diffusion(cfg, rng=jax.random.key(0))
  msm = MultiSepValueModel(ConvGRUValueModel(), n_models=2,
                           num_steps=cfg.sampling.steps)
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  tr = train_val.MultiSepTrainer(
      model, msm, reward_fn,
      train_val.ValueTrainerConfig(batch_size=4, learning_rate=1e-3))
  st = tr.init_state(jax.random.key(1))
  st, (loss0, _) = tr._train_step(st, None)
  for _ in range(10):
    st, (loss, per_bin) = tr._train_step(st, None)
  assert float(loss) < float(loss0)
  assert per_bin.shape == (2,)


def test_fit_logs_metrics_and_sample_quality(cfg, tmp_path):
  """Trainer.fit writes train/val rows AND the sample-quality metrics
  (ws/kmer) through MetricsLogger when a sample_eval_fn is wired
  (VERDICT r1 items 2+5: the reference computes these every validation
  epoch, diffusion_gosai.py:451-565)."""
  import json
  from svdd import rewards
  from svdd.eval import validation
  from svdd.observability import MetricsLogger

  model = Diffusion(cfg, rng=jax.random.key(0))
  ds = GosaiDataset('train', length=cfg.model.length)
  it = FaultTolerantIterator(ds, 8, seed=0)
  logger = MetricsLogger(log_dir=str(tmp_path), run_name='t')
  oracle_fn = rewards.synthetic_motif_oracle(cfg.model.length)

  def sample_eval_fn(ema_vars, key):
    return validation.distribution_eval(
        model, ema_vars, {'train': ds}, key, oracle_fn=oracle_fn,
        n_batches=1, batch_size=8, subset_size=32)

  trainer = train_diff.Trainer(model, cfg, logger=logger,
                               sample_eval_fn=sample_eval_fn)
  state = trainer.init_or_restore(jax.random.key(1))
  trainer.fit(state, it, valid_iter=FaultTolerantIterator(ds, 8, seed=1),
              num_steps=4, log_every=2, eval_every=4, ckpt_every=10**9)
  logger.finish()

  rows = [json.loads(l) for l in open(logger.path)]
  keys = set().union(*[set(r) for r in rows])
  assert 'train/loss' in keys
  assert 'val/nll' in keys
  assert 'kmer_pearson' in keys
  assert any(k.startswith('ws/') for k in keys)


def test_checkpoint_roundtrip(cfg, tmp_path):
  model = Diffusion(cfg, rng=jax.random.key(0))
  trainer = train_diff.Trainer(model, cfg, ckpt_dir=str(tmp_path))
  ds = GosaiDataset('train', length=cfg.model.length)
  train_iter = FaultTolerantIterator(ds, 8, seed=0)
  it = iter(train_iter)
  state = trainer.init_or_restore(jax.random.key(1))
  for _ in range(3):
    batch = {k: jnp.asarray(v) for k, v in next(it).items()}
    state, _ = trainer.train_step(state, batch)
  train_diff.save_checkpoint(str(tmp_path), state,
                             train_iter.state_dict())

  # fresh trainer restores step + params + iterator position
  state2 = train_diff.init_state(model, cfg, jax.random.key(9))
  train_iter2 = FaultTolerantIterator(ds, 8, seed=0)
  restored = train_diff.restore_checkpoint(str(tmp_path), state2,
                                           train_iter2)
  assert int(restored.step) == 3
  np.testing.assert_allclose(
      np.asarray(jax.tree.leaves(restored.params)[0]),
      np.asarray(jax.tree.leaves(state.params)[0]), rtol=1e-6)
  assert train_iter2.counter == train_iter.counter

  # async manager path (the fit loop's non-blocking saves): one more
  # step, save through the persistent manager, restore the newer step
  batch = {k: jnp.asarray(v) for k, v in next(it).items()}
  state, _ = trainer.train_step(state, batch)
  trainer.save_async(state, train_iter.state_dict())
  trainer.finalize_checkpoints()
  restored2 = train_diff.restore_checkpoint(
      str(tmp_path), train_diff.init_state(model, cfg, jax.random.key(2)))
  assert int(restored2.step) == 4


def test_best_checkpoint_keeps_lowest_val_nll(cfg, tmp_path):
  """save_best_async mirrors ModelCheckpoint(monitor='val/nll',
  mode='min') (main_gosai.py:193-198): across saves with varying NLL
  only the LOWEST-NLL step survives in <ckpt_dir>/best, and
  restore_best_checkpoint returns exactly that step."""
  model = Diffusion(cfg, rng=jax.random.key(0))
  trainer = train_diff.Trainer(model, cfg, ckpt_dir=str(tmp_path))
  ds = GosaiDataset('train', length=cfg.model.length)
  it = iter(FaultTolerantIterator(ds, 8, seed=0))
  state = trainer.init_or_restore(jax.random.key(1))
  # step -> synthetic val/nll; step 2 is the best and NOT the latest
  for nll in (3.0, 1.5, 2.5):
    batch = {k: jnp.asarray(v) for k, v in next(it).items()}
    state, _ = trainer.train_step(state, batch)
    trainer.save_best_async(state, nll)
  trainer.finalize_checkpoints()

  best = train_diff.restore_best_checkpoint(
      str(tmp_path), train_diff.init_state(model, cfg,
                                           jax.random.key(7)))
  assert int(best.step) == 2
  import os
  kept = [d for d in os.listdir(tmp_path / 'best') if d.isdigit()]
  assert kept == ['2']


def test_iterator_resume_mid_epoch():
  ds = GosaiDataset('train', length=16)
  a = FaultTolerantIterator(ds, 8, seed=0)
  ia = iter(a)
  [next(ia) for _ in range(5)]
  st = a.state_dict()
  next_batch = next(ia)

  b = FaultTolerantIterator(ds, 8, seed=0)
  b.load_state_dict(st)
  resumed = next(iter(b))
  np.testing.assert_array_equal(next_batch['seqs'], resumed['seqs'])


def test_iterator_sharding_disjoint():
  ds = GosaiDataset('train', length=16)
  s0 = FaultTolerantIterator(ds, 4, seed=0, num_shards=2, shard_index=0)
  s1 = FaultTolerantIterator(ds, 4, seed=0, num_shards=2, shard_index=1)
  b0 = next(iter(s0))['seqs']
  b1 = next(iter(s1))['seqs']
  assert not np.array_equal(b0, b1)


def test_timed_value_training(cfg):
  """TimedEnformer-style value training: per-state step indices flow
  through mc_targets into the timed module."""
  from svdd.models.convgru import ConvGRUValueModel
  import flax.linen as nn

  class TimedToy(nn.Module):
    @nn.compact
    def __call__(self, x, time_indices, train=False):
      emb = nn.Embed(cfg.sampling.steps + 1, 4)(
          jnp.clip(time_indices, 0, cfg.sampling.steps))
      x = x + 0.01 * emb
      return nn.Dense(1)(x.mean(axis=1))[..., 0]

  model = Diffusion(cfg, rng=jax.random.key(0))
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  module = TimedToy()
  variables = module.init(
      jax.random.key(1), jnp.zeros((1, cfg.model.length, 4)),
      jnp.zeros((1, cfg.model.length), jnp.int32))
  vf = value_lib.ValueFunction(module, variables, cfg.model.length,
                               timed=True)
  tcfg = train_val.ValueTrainerConfig(batch_size=4, learning_rate=1e-3)
  trainer = train_val.ValueTrainer(model, vf, reward_fn, tcfg)
  state = trainer.init_state(jax.random.key(2))
  losses = []
  for _ in range(30):
    state, loss = trainer._train_step(state, None)
    losses.append(float(loss))
  assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_native_sharded_csv_reader(tmp_path):
  """csv_read_gosai (one-pass native reader): full read matches the
  pandas path, row-range shards are disjoint and cover the file."""
  import csv as _csv
  rng = np.random.default_rng(0)
  L, N = 12, 23
  alpha = np.array(list('ACGT'))
  seqs = [''.join(alpha[rng.integers(0, 4, L)]) for _ in range(N)]
  vals = rng.normal(size=(N, 3)).astype(np.float32)
  path = tmp_path / 'gosai_train.csv'
  with open(path, 'w', newline='') as f:
    w = _csv.writer(f)
    w.writerow(['id', 'seq', 'hepg2', 'k562', 'sknsh'])
    for i in range(N):
      w.writerow([i, seqs[i], *[f'{v:.6f}' for v in vals[i]]])

  from svdd.native import bindings
  toks, clss = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L)
  assert toks.shape == (N, L) and clss.shape == (N, 3)
  from svdd.data.gosai import dna_tokenize_batch
  np.testing.assert_array_equal(toks, dna_tokenize_batch(seqs))
  np.testing.assert_allclose(clss, vals, atol=1e-5)
  assert bindings.csv_count_rows(str(path)) == N

  # contiguous shards: disjoint, ordered, covering
  t0, c0 = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L,
      row_offset=0, max_rows=10)
  t1, c1 = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L,
      row_offset=10, max_rows=13)
  np.testing.assert_array_equal(np.concatenate([t0, t1]), toks)
  np.testing.assert_allclose(np.concatenate([c0, c1]), clss)


def test_native_csv_empty_fields_and_shard_bounds(tmp_path):
  """ADVICE r1 regressions: (1) an EMPTY CSV field must not shift
  later column indices (strtok_r collapsed consecutive delimiters);
  (2) shards are bounded by RAW lines consumed, so a shard containing
  a malformed row yields fewer rows instead of stealing rows from the
  next host's shard."""
  from svdd.native import bindings
  L = 8
  path = tmp_path / 'gosai_train.csv'
  rows = [
      ('0', '', 'ACGTACGT', '1.5', '2.5', '3.5'),     # empty 2nd col
      ('1', 'x', 'TTTTAAAA', '4.5', '5.5', '6.5'),
      ('2', '', 'BADLEN', '9.0', '9.0', '9.0'),       # malformed seq
      ('3', 'y', 'CCCCGGGG', '7.5', '8.5', '9.5'),
  ]
  with open(path, 'w') as f:
    f.write('id,note,seq,hepg2,k562,sknsh\n')
    for r in rows:
      f.write(','.join(r) + '\n')

  toks, clss = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L)
  # row 0's empty field must NOT shift hepg2 into the seq slot
  assert toks.shape[0] == 3
  np.testing.assert_allclose(
      clss, [[1.5, 2.5, 3.5], [4.5, 5.5, 6.5], [7.5, 8.5, 9.5]])

  # raw-line shard bound: shard [0, 3) contains the malformed row ->
  # yields 2 valid rows and must NOT consume row 3 (next shard's)
  t0, c0 = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L,
      row_offset=0, max_rows=3)
  t1, c1 = bindings.csv_read_gosai(
      str(path), 'seq', ['hepg2', 'k562', 'sknsh'], L,
      row_offset=3, max_rows=1)
  assert t0.shape[0] == 2 and t1.shape[0] == 1
  np.testing.assert_allclose(c1, [[7.5, 8.5, 9.5]])


def test_dataset_row_sharding(tmp_path, cfg):
  """GosaiDataset(row_offset,row_limit) + get_dataloaders(shard_data):
  two hosts hold disjoint halves."""
  import csv as _csv
  rng = np.random.default_rng(1)
  L, N = cfg.model.length, 32
  alpha = np.array(list('ACGT'))
  path = tmp_path / 'gosai_train.csv'
  with open(path, 'w', newline='') as f:
    w = _csv.writer(f)
    w.writerow(['seq', 'hepg2', 'k562', 'sknsh'])
    for i in range(N):
      w.writerow([''.join(alpha[rng.integers(0, 4, L)]),
                  float(i), 0.0, 0.0])

  from svdd.data.gosai import GosaiDataset
  half0 = GosaiDataset('train', length=L, data_dir=str(tmp_path),
                       row_offset=0, row_limit=16)
  half1 = GosaiDataset('train', length=L, data_dir=str(tmp_path),
                       row_offset=16, row_limit=16)
  assert len(half0) == 16 and len(half1) == 16
  assert set(half0.clss[:, 0]) == set(range(16))
  assert set(half1.clss[:, 0]) == set(range(16, 32))

  from svdd.data import gosai as G
  cfg.loader.global_batch_size = 8
  cfg.loader.eval_global_batch_size = 8
  it0, _, _ = G.get_dataloaders(cfg, num_shards=2, shard_index=0,
                                skip_valid=True, data_dir=str(tmp_path),
                                shard_data=True)
  it1, _, _ = G.get_dataloaders(cfg, num_shards=2, shard_index=1,
                                skip_valid=True, data_dir=str(tmp_path),
                                shard_data=True)
  seen0 = set(np.asarray(next(iter(it0))['clss'])[:, 0])
  seen1 = set(np.asarray(next(iter(it1))['clss'])[:, 0])
  assert seen0.isdisjoint(seen1)


def test_grad_accumulation_matches_manual_average(cfg):
  """training.accum_steps=2 must equal one update from the hand-average
  of the two microbatch grads (same key-splitting discipline)."""
  import copy
  import optax
  from svdd.models import ema as ema_lib

  c2 = copy.deepcopy(cfg)
  c2.training.accum_steps = 2
  model = Diffusion(c2, rng=jax.random.key(0))
  ds = GosaiDataset('train', length=c2.model.length)
  batch = {k: jnp.asarray(v)
           for k, v in next(iter(FaultTolerantIterator(
               ds, 8, seed=0))).items()}

  state = train_diff.init_state(model, c2, jax.random.key(7))
  step = jax.jit(train_diff.make_train_step(model, c2))
  new_state, loss = step(state, batch)

  # manual: replicate the rng discipline of train_step
  rng, loss_key, drop_key = jax.random.split(state.rng, 3)
  lks = jax.random.split(loss_key, 2)
  dks = jax.random.split(drop_key, 2)
  mbs = jax.tree.map(
      lambda x: x.reshape((2, x.shape[0] // 2) + x.shape[1:]), batch)

  def loss_fn(params, mb, lk, dk):
    variables = {'params': params, **state.extras}
    return model.loss(variables, lk, mb['seqs'],
                      mb.get('attention_mask'), train=True,
                      dropout_rng=dk).loss

  want_loss = 0.0
  grad_sum = jax.tree.map(jnp.zeros_like, state.params)
  for i in range(2):
    mb = jax.tree.map(lambda x, i=i: x[i], mbs)
    l, g = jax.value_and_grad(loss_fn)(state.params, mb, lks[i], dks[i])
    want_loss += float(l) / 2
    grad_sum = jax.tree.map(lambda a, b: a + b / 2, grad_sum, g)

  opt = train_diff.make_optimizer(c2)
  updates, _ = opt.update(grad_sum, state.opt_state, state.params)
  want_params = optax.apply_updates(state.params, updates)

  assert abs(float(loss) - want_loss) < 1e-5
  got, want = jax.tree.leaves(new_state.params), jax.tree.leaves(
      want_params)
  for a, b in zip(got, want):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=1e-5, rtol=1e-5)


def test_value_trainer_state_roundtrip(cfg, tmp_path):
  """save_state/restore_state: optimizer moments, token counter and the
  rng stream continue exactly (reference trainer.py:73-96 semantics)."""
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  vf = value_lib.ValueFunction.create('rna', cfg.model.length,
                                      jax.random.key(2))
  tcfg = train_val.ValueTrainerConfig(batch_size=4, lr_decay=True)
  trainer = train_val.ValueTrainer(model, vf, reward_fn, tcfg)
  state = trainer.init_state(jax.random.key(3))
  for _ in range(3):
    state, _ = trainer._train_step(state, None)

  path = str(tmp_path / 'vstate')
  trainer.save_state(path, state)
  restored = trainer.restore_state(path, jax.random.key(99))
  assert int(restored.step) == int(state.step)
  for a, b in zip(jax.tree.leaves(state.params),
                  jax.tree.leaves(restored.params)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  for a, b in zip(jax.tree.leaves(state.opt_state),
                  jax.tree.leaves(restored.opt_state)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  # continuing produces finite losses and advances the step
  restored, loss = trainer._train_step(restored, None)
  assert int(restored.step) == int(state.step) + 1
  assert np.isfinite(float(loss))


def test_multisep_state_roundtrip(cfg, tmp_path):
  from svdd.models.multisep import MultiSepValueModel
  from svdd.value import build_value_module
  model = Diffusion(cfg, rng=jax.random.key(0))
  module = build_value_module('rna', 'enformer', n_tasks=1)
  msm = MultiSepValueModel(module, n_models=4,
                           num_steps=cfg.sampling.steps)
  tcfg = train_val.ValueTrainerConfig(batch_size=4)
  tr = train_val.MultiSepTrainer(
      model, msm, rewards.synthetic_motif_oracle(cfg.model.length),
      tcfg)
  st = tr.train(tr.init_state(jax.random.key(1)), 2)
  path = str(tmp_path / 'ms_state')
  tr.save_state(path, st)
  r = tr.restore_state(path, jax.random.key(9))
  assert int(r[0]) == int(st[0])
  for a, b in zip(jax.tree.leaves(st[1]), jax.tree.leaves(r[1])):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  r = tr.train(r, 1)
  assert int(r[0]) == int(st[0]) + 1


def test_value_bf16_env_knob(monkeypatch):
  """SVDD_VALUE_BF16=1 switches the Enformer value net to bf16 compute
  (value.build_value_module); params stay f32 and scores track the f32
  module. Explicit compute_dtype kwargs win over the env."""
  from svdd.value import build_value_module
  tiny = dict(n_conv=3, channels=256, n_transformers=1, n_heads=2,
              key_len=8)

  monkeypatch.delenv('SVDD_VALUE_BF16', raising=False)
  m32 = build_value_module('dna', 'enformer', **tiny)
  assert m32.compute_dtype == jnp.float32
  monkeypatch.setenv('SVDD_VALUE_BF16', '1')
  m16 = build_value_module('dna', 'enformer', **tiny)
  assert m16.compute_dtype == jnp.bfloat16
  explicit = build_value_module('dna', 'enformer',
                                compute_dtype=jnp.float32, **tiny)
  assert explicit.compute_dtype == jnp.float32

  x = jax.random.uniform(jax.random.key(0), (2, 16, 4))
  variables = m32.init(jax.random.key(1), x)
  got32 = np.asarray(m32.apply(variables, x))
  got16 = np.asarray(m16.apply(variables, x))
  # params are f32 either way (param_dtype default); only compute
  # rounds through bf16
  assert all(a.dtype == np.float32
             for a in jax.tree.leaves(variables))
  assert got16.dtype == np.float32
  np.testing.assert_allclose(got16, got32, rtol=0.05, atol=0.05)
