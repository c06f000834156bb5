#!/usr/bin/env python3
"""Main-path smoke test on an NVIDIA GPU, at full model width.

    python chip_smoke.py           # one GPU, every single-card phase
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One process drives the card(s). Each phase prints its name, seconds and
the device's peak bytes in use on its own line:

  device        the default JAX backend must be a GPU; prints the card's
                name and power limit, the jax version, the compile-cache
                directory and XLA_FLAGS
  decode_mc     svdd.cli.decode through its own parser: SVDD-MC, DNA
                task, CNN denoiser (hidden 128, 4 stacks) + Enformer-1536
                value net, B=64, M=10, 128 steps
  decode_algos  SVDD-PM, TDS, DPS and classifier guidance at the same
                widths (Enformer-1536 as the reward), B=64, 16 steps
  numerics      GPU vs the same function on the host CPU: CNN logits and
                Enformer-1536 values at f32 'highest', at the default
                (TF32) precision and in bf16, each against its bound
  train         svdd.cli.main_gosai (global batch 512) and svdd.cli.train
                (Enformer-1536 value net on its self-generated
                trajectory), a few steps each
  aot           the decode_mc sampler through aot.export_compiled /
                load_compiled; the loaded executable must reproduce the
                live samples

--four runs only the four-card phase on a ('data', 'model') = (4, 1)
mesh: candidate-sharded SVDD-MC (its value scores against the same
candidates scored on one card, then the full decode), and one DP+FSDP
diffusion train step against the one-card step: the exchanged gradient
and the parameter update, leaf by leaf.

Any failure exits non-zero and prints no result. The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# decode / train shapes (full width; batch, steps and depth as stated)
DECODE_B, DECODE_M, DECODE_STEPS = 64, 10, 128
ALGO_STEPS = 16
NUMERICS_ROWS = 16
MAIN_GOSAI_STEPS = 4
VALUE_TRAIN_B, VALUE_TRAIN_ITERS = 16, 3
FOUR_B, FOUR_M, FOUR_STEPS = 256, 10, 4

# |gpu - cpu|_max / |cpu|_max bounds, CPU f32 at 'highest' as reference.
# 'highest' differs from the CPU only in summation order (f32 ulp
# ~6e-8 per op, a few thousand ops deep); TF32 keeps 10 mantissa bits
# (~5e-4 per product); bf16 keeps 8 bits (~4e-3) at every activation
# cast. Measured on an H100: ~1e-6, ~1e-3 and ~1e-2 (PERF.md).
NUMERIC_BOUNDS = {'highest': 1e-4, 'default': 1e-2, 'bf16': 5e-2}

# Worst-leaf |sharded - one card|_2 / |one card|_2 after one DP+FSDP
# train step at 'highest'. The gradient differs only in summation order.
# Adam's first update is about lr * sign(gradient), so an element whose
# gradient is within rounding of zero may flip and move by 2 lr: a few
# such elements in a 147k-element leaf give ~1e-2. A gradient not
# exchanged, or exchanged wrongly, changes the sign of a large share of
# the elements and gives O(1).
FOUR_TRAIN_BOUNDS = {'gradient': 1e-4, 'update': 5e-2}


class SmokeFailure(RuntimeError):
  pass


def check(cond, msg: str) -> None:
  if not cond:
    raise SmokeFailure(msg)


def _peak_bytes() -> int:
  import jax
  stats = jax.devices()[0].memory_stats() or {}
  return int(stats.get('peak_bytes_in_use', 0))


@contextlib.contextmanager
def phase(name: str):
  print(f'[phase] {name} start', flush=True)
  t0 = time.perf_counter()
  yield
  print(f'[phase] {name} ok {time.perf_counter() - t0:.1f}s '
        f'peak {_peak_bytes() / 2 ** 30:.2f} GiB', flush=True)


@contextlib.contextmanager
def patched(obj, name: str, value):
  old = getattr(obj, name)
  setattr(obj, name, value)
  try:
    yield
  finally:
    setattr(obj, name, old)


@contextlib.contextmanager
def patched_config(name: str, value):
  import jax
  old = getattr(jax.config, name)
  jax.config.update(name, value)
  try:
    yield
  finally:
    jax.config.update(name, old)


@contextlib.contextmanager
def argv(args: list[str]):
  old = sys.argv
  sys.argv = args
  try:
    yield
  finally:
    sys.argv = old


def nvidia_smi() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      timeout=60, check=True).stdout.strip()
  check(out, 'nvidia-smi printed no card')
  return out


def require_gpu(count: int):
  import jax
  devs = jax.devices()
  check(devs[0].platform == 'gpu',
        f'no GPU: the default JAX backend is {devs[0].platform!r}')
  check(len(devs) >= count, f'need {count} GPUs, found {len(devs)}')
  return devs


def dna_config(steps: int):
  from svdd.config import dna_config as base
  cfg = base()
  cfg.sampling.steps = steps
  return cfg


def value_module(dtype=None):
  """The Enformer-1536 value/reward net (decode.py:78-80 widths)."""
  import jax.numpy as jnp
  from svdd.models.enformer import EnformerValueModel
  return EnformerValueModel(n_tasks=1,
                            compute_dtype=dtype or jnp.float32)


def _no_mask(samples, mask_index: int, shape) -> None:
  samples = np.asarray(samples)
  check(samples.shape == tuple(shape), f'samples {samples.shape}')
  check(not (samples == mask_index).any(), 'MASK tokens left')
  check(((samples >= 0) & (samples < mask_index)).all(),
        'tokens out of range')


def _finite(x, what: str) -> np.ndarray:
  x = np.asarray(x, np.float64)
  check(np.isfinite(x).all(), f'{what} not finite')
  return x


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(count: int):
  import jax
  devs = require_gpu(count)
  from svdd import utils
  utils.enable_compile_cache()
  print(nvidia_smi(), flush=True)
  print(f'jax {jax.__version__}; devices {devs[:count]}', flush=True)
  print(f'compile cache {jax.config.jax_compilation_cache_dir}; '
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
  return devs[:count]


def phase_decode_mc(work: str) -> None:
  from svdd.cli import decode as cli_decode
  results = []

  def capture(*a, **k):
    results.append(cli_decode_run(*a, **k))
    return results[-1]

  cli_decode_run = cli_decode.run_decode
  cmd = ['svdd.cli.decode', '--task', 'dna', '--sample_M',
         str(DECODE_M), '--num_steps', str(DECODE_STEPS), '--batch_size',
         str(DECODE_B), '--out_dir', work]
  print(' '.join(cmd), flush=True)
  with patched(cli_decode, 'run_decode', capture), argv(cmd):
    cli_decode.main()
  cfg = dna_config(DECODE_STEPS)
  npz = np.load(os.path.join(work, 'dna-HepG2.npz'))
  check(set(npz.files) == {'decoding', 'baseline'}, f'npz {npz.files}')
  dec = _finite(npz['decoding'], 'decoding rewards')
  base = _finite(npz['baseline'], 'baseline rewards')
  check(dec.shape == (DECODE_B,) and base.shape == (DECODE_B,),
        f'reward shapes {dec.shape} {base.shape}')
  _no_mask(results[0].samples, cfg.mask_index,
           (DECODE_B, cfg.model.length))
  _finite(results[0].value_preds, 'value scores')
  print(f'decode_mc rewards: guided mean {dec.mean():.4f} vs baseline '
        f'{base.mean():.4f}', flush=True)


def _enformer_reward(length: int, dtype=None):
  import jax
  import jax.numpy as jnp
  vm = value_module(dtype)
  vv = jax.jit(vm.init)(jax.random.key(1), jnp.zeros((1, length, 4)))
  return vm, vv, (lambda v, onehot: vm.apply(v, onehot), vv)


def phase_decode_algos() -> None:
  import jax
  from svdd.decode import run_decode
  from svdd.diffusion import Diffusion
  cfg = dna_config(ALGO_STEPS)
  model = Diffusion(cfg, rng=jax.random.key(0))
  _, _, reward = _enformer_reward(cfg.model.length)
  for algo in ('svdd_pm', 'tds', 'dps', 'classifier'):
    t0 = time.perf_counter()
    res = run_decode(model, reward, algo=algo,
                     value_fn=reward if algo == 'classifier' else None,
                     batch_size=DECODE_B, sample_M=DECODE_M, alpha=0.5,
                     skip_best_of_n=True, seed=3)
    _no_mask(res.samples, cfg.mask_index, (DECODE_B, cfg.model.length))
    r = _finite(res.reward_preds, f'{algo} rewards')
    _finite(res.baseline_preds, f'{algo} baseline rewards')
    print(f'{algo}: {time.perf_counter() - t0:.1f}s (compile + run), '
          f'reward mean {r.mean():.4f}', flush=True)


def _rel(got, want) -> float:
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _worst_leaf(got, want) -> tuple[float, str]:
  """Largest |got - want|_2 / |want|_2 over the leaves, and its path."""
  import jax
  worst = (0.0, '')
  for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                          jax.tree.leaves(want)):
    g = np.asarray(g, np.float64)
    w = np.asarray(w, np.float64)
    err = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    if err >= worst[0]:
      worst = (err, jax.tree_util.keystr(path))
  return worst


def _adam_first_moment(opt_state):
  import jax
  import optax
  states = [s for s in jax.tree.leaves(
      opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
      if isinstance(s, optax.ScaleByAdamState)]
  check(len(states) == 1, f'{len(states)} Adam states in the optimizer')
  return states[0].mu


def phase_numerics() -> None:
  import jax
  import jax.numpy as jnp
  from svdd.diffusion import Diffusion
  from svdd.models.cnn import CNNModel
  cpu = jax.devices('cpu')[0]
  gpu = jax.devices()[0]
  cfg = dna_config(ALGO_STEPS)
  model = Diffusion(cfg, rng=jax.random.key(0))
  key = jax.random.key(5)
  tokens = jax.random.randint(key, (NUMERICS_ROWS, cfg.model.length),
                              0, cfg.vocab_size)
  sigma = jnp.zeros((NUMERICS_ROWS,))
  cnn32 = model.backbone
  cnn16 = CNNModel(config=cfg, alphabet_size=cfg.vocab_size, num_cls=3,
                   compute_dtype=jnp.bfloat16)
  vm32, vv, _ = _enformer_reward(cfg.model.length)
  vm16 = value_module(jnp.bfloat16)
  onehot = jax.nn.one_hot(tokens % 4, 4)
  nets = {
      'cnn_logits': (cnn32, cnn16, model.variables, (tokens, sigma)),
      'enformer1536_value': (vm32, vm16, vv, (onehot,)),
  }
  for name, (m32, m16, variables, args) in nets.items():
    f32 = jax.jit(m32.apply)
    f16 = jax.jit(m16.apply)
    with jax.default_matmul_precision('highest'):
      want = np.asarray(f32(*jax.device_put((variables,) + args, cpu)))
      got = {'highest': f32(*jax.device_put((variables,) + args, gpu))}
    got['default'] = f32(*jax.device_put((variables,) + args, gpu))
    got['bf16'] = f16(*jax.device_put((variables,) + args, gpu))
    for prec, out in got.items():
      err = _rel(out, want)
      bound = NUMERIC_BOUNDS[prec]
      print(f'numerics {name} {prec}: rel err {err:.3e} '
            f'(bound {bound:.0e})', flush=True)
      check(err <= bound, f'{name} {prec}: {err:.3e} > {bound:.0e}')


class _StepLog:
  """Times a wrapped train step and records its loss."""

  def __init__(self, label: str):
    self.label = label
    self.losses = []

  def wrap(self, step):
    import jax

    def timed(*a, **k):
      t0 = time.perf_counter()
      state, loss = step(*a, **k)
      loss = float(jax.block_until_ready(loss))
      dt = time.perf_counter() - t0
      self.losses.append(loss)
      print(f'{self.label} step {len(self.losses)}: loss {loss:.5f} '
            f'{dt * 1e3:.1f} ms', flush=True)
      return state, loss
    return timed

  def check(self, n: int) -> None:
    check(len(self.losses) == n, f'{self.label}: {len(self.losses)} steps')
    _finite(self.losses, f'{self.label} losses')


def phase_train(work: str) -> None:
  from svdd.cli import main_gosai, train as cli_train
  from svdd.train import diffusion as train_diff
  from svdd.train import value as train_val

  log = _StepLog('main_gosai')
  post_init = train_diff.Trainer.__post_init__

  def post(self):
    post_init(self)
    self.train_step = log.wrap(self.train_step)

  cmd = ['svdd.cli.main_gosai', '--task', 'dna', '--max_steps',
         str(MAIN_GOSAI_STEPS), '--ckpt_dir', '', '--no_sample_eval',
         '--log_dir', work]
  print(' '.join(cmd), flush=True)
  with patched(train_diff.Trainer, '__post_init__', post), argv(cmd):
    main_gosai.main()
  log.check(MAIN_GOSAI_STEPS)

  vlog = _StepLog('value_train')
  cmd = ['svdd.cli.train', '--task', 'dna', '--batch_size',
         str(VALUE_TRAIN_B), '--max_iters', str(VALUE_TRAIN_ITERS),
         '--eval_every', str(VALUE_TRAIN_ITERS), '--val_batch_num', '0',
         '--out_dir', work]
  print(' '.join(cmd), flush=True)
  step = train_val.ValueTrainer._train_step
  with patched(train_val.ValueTrainer, '_train_step',
               lambda self, *a: vlog.wrap(
                   lambda *b: step(self, *b))(*a)), argv(cmd):
    cli_train.main()
  vlog.check(VALUE_TRAIN_ITERS)


def phase_aot(work: str) -> None:
  import jax
  from svdd import aot, value as value_lib
  from svdd.diffusion import Diffusion
  cfg = dna_config(DECODE_STEPS)
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  vf = value_lib.ValueFunction.create('dna', cfg.model.length,
                                      jax.random.key(1))
  sampler = model.controlled_sampler(vf.as_token_pair(), DECODE_B,
                                     sample_M=DECODE_M)
  path = os.path.join(work, 'svdd_mc.svddc')
  # compile afresh: an executable served from the persistent compile
  # cache is not the object this phase means to serialize
  with patched_config('jax_enable_compilation_cache', False):
    size, compiled = aot.export_compiled(sampler, path,
                                         return_compiled=True)
  loaded = aot.load_compiled(path)
  key = jax.random.key(11)
  live = np.asarray(compiled(*sampler.default_args, key).samples)
  got = np.asarray(loaded(*sampler.default_args, key).samples)
  _no_mask(got, cfg.mask_index, (DECODE_B, cfg.model.length))
  same = float((live == got).mean())
  print(f'aot artifact {size / 1e6:.1f} MB; loaded == live on '
        f'{same:.4%} of tokens', flush=True)
  check(same == 1.0, 'loaded executable samples differ from live')


def phase_four() -> None:
  import jax
  from svdd import mdlm
  from svdd.cli import main_gosai
  from svdd.data import gosai
  from svdd.diffusion import Diffusion
  from svdd.parallel import mesh as M
  from svdd.train import diffusion as train_diff

  devs = jax.devices()[:4]
  mesh = M.make_mesh(data=4, model=1, devices=devs)
  print(f'mesh {dict(mesh.shape)}', flush=True)
  cfg = dna_config(FOUR_STEPS)
  model = Diffusion(cfg, rng=jax.random.key(0))
  vm, vv, _ = _enformer_reward(cfg.model.length)
  value = (lambda v, tok: vm.apply(v, mdlm.transform_samples(tok)), vv)

  # value scores of the same folded candidate batch, sharded as the
  # decode shards it vs on one card
  cands = jax.random.randint(jax.random.key(2),
                             (FOUR_B * FOUR_M, cfg.model.length), 0, 5)
  score = jax.jit(value[0])
  one = np.asarray(score(*jax.device_put((vv, cands), devs[0])))
  sharded = score(M.replicate(vv, mesh),
                  jax.device_put(cands, M.candidate_sharding(mesh)))
  check(len(sharded.sharding.device_set) == 4, 'scores not sharded')
  err = _rel(sharded, one)
  print(f'four: candidate value scores sharded vs one card rel err '
        f'{err:.3e} (bound {NUMERIC_BOUNDS["default"]:.0e})', flush=True)
  check(err <= NUMERIC_BOUNDS['default'], 'sharded value scores differ')

  t0 = time.perf_counter()
  res = model.controlled_sampler(value, FOUR_B, sample_M=FOUR_M,
                                 mesh=mesh)(jax.random.key(4))
  _no_mask(res.samples, cfg.mask_index, (FOUR_B, cfg.model.length))
  print(f'four: SVDD-MC B={FOUR_B} M={FOUR_M} {FOUR_STEPS} steps on 4 '
        f'cards: {time.perf_counter() - t0:.1f}s (compile + run)',
        flush=True)

  # one DP+FSDP step of the main_gosai trainer vs the one-card step. The
  # default schedule warms up from lr 0, so the check runs at the
  # constant lr, and without clipping: Adam's first moment after the
  # step is then (1 - b1) x the gradient exchanged across the cards, and
  # the parameters move by the update made from it.
  tcfg = main_gosai.build_config(argparse.Namespace(
      config=None, task='dna', set=['parallel.fsdp=true',
                                    'optim.warmup_steps=0',
                                    'optim.grad_clip=1e30']))
  train_it, _, _ = gosai.get_dataloaders(tcfg)
  batch = next(iter(train_it))
  got = {}
  for label, m in (('dp_fsdp_4', mesh), ('one_card', None)):
    tmodel = Diffusion(tcfg, rng=jax.random.key(tcfg.seed))
    trainer = train_diff.Trainer(tmodel, tcfg, mesh=m)
    state = trainer.init_or_restore(jax.random.key(tcfg.seed))
    if m is not None:
      check(any(not p.sharding.is_fully_replicated
                for p in jax.tree.leaves(state.params)),
            'FSDP sharded no parameter')
    before = jax.device_get(state.params)
    with jax.default_matmul_precision('highest'):
      state, loss = trainer.train_step(state, trainer._put(batch))
      loss = float(jax.block_until_ready(loss))
    got[label] = {
        'gradient': jax.device_get(_adam_first_moment(state.opt_state)),
        'update': jax.tree.map(np.subtract, jax.device_get(state.params),
                               before)}
    print(f'four: {label} train loss {loss}', flush=True)
  moved = max(float(np.abs(u).max())
              for u in jax.tree.leaves(got['one_card']['update']))
  check(moved > 0, 'the train step left the parameters unchanged')
  for what, bound in FOUR_TRAIN_BOUNDS.items():
    err, leaf = _worst_leaf(got['dp_fsdp_4'][what], got['one_card'][what])
    print(f'four: DP+FSDP vs one-card {what} worst-leaf rel err '
          f'{err:.3e} at {leaf} (bound {bound:.0e})', flush=True)
    check(err <= bound, f'DP+FSDP {what} differs at {leaf}')


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--four', action='store_true',
                 help='run only the four-GPU sharded phase')
  args = p.parse_args()
  count = 4 if args.four else 1
  try:
    with phase('device'):
      devs = phase_device(count)
    with tempfile.TemporaryDirectory() as work:
      if args.four:
        with phase('four'):
          phase_four()
      else:
        with phase('decode_mc'):
          phase_decode_mc(work)
        with phase('decode_algos'):
          phase_decode_algos()
        with phase('numerics'):
          phase_numerics()
        with phase('train'):
          phase_train(work)
        with phase('aot'):
          phase_aot(work)
  except SmokeFailure as e:
    print(f'FAIL: {e}', file=sys.stderr, flush=True)
    return 1
  print(json.dumps({'ok': True, 'device': {
      'platform': devs[0].platform, 'kind': devs[0].device_kind,
      'count': len(devs)}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
