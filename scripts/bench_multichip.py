"""Multi-chip readiness bench: sweep the parallel strategies over an
n-device mesh, report seqs/sec/chip + scaling efficiency vs a
single-chip run of the same code, and assert the comm-budget
invariants from the compiled HLO on the way (VERDICT r2 item 6).

On a multi-GPU host (one JAX process drives every card):

    python scripts/bench_multichip.py                    # all devices

Without one, wiring is validated on the virtual CPU mesh:

    python scripts/bench_multichip.py --virtual --devices 8 --small

Configs swept (one JSON line each):
  decode_candidate_dp  SVDD-MC guided decode, folded B*M candidates
                       sharded over ALL devices (parallel/mesh.py
                       candidate_sharding). Invariant: ZERO
                       collectives per step.
  decode_weight_tp     SVDD-MC decode, Megatron column/row-sharded
                       Enformer value net over the 'model' axis.
                       Invariant: all-reduce is the ONLY collective.
  dp_train             diffusion pretrain step, batch over 'data'.
                       Invariant: all-reduce (grad psum) only.
  fsdp_train           same with params+opt sharded (ZeRO). No kind
                       invariant (XLA reshards freely); the measured
                       breakdown is reported.

Reference scaling story this replaces: Lightning DDP/FSDP NCCL
(SURVEY.md §2.2); the reference never scales DECODE at all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from comm_budget import parse_collectives  # noqa: E402


def _force_virtual_cpu(n: int) -> None:
  import re
  os.environ['JAX_PLATFORMS'] = 'cpu'
  flags = os.environ.get('XLA_FLAGS', '')
  pat = re.compile(r'--xla_force_host_platform_device_count=(\d+)')
  if pat.search(flags):
    flags = pat.sub(f'--xla_force_host_platform_device_count={n}',
                    flags)
  else:
    flags = (flags +
             f' --xla_force_host_platform_device_count={n}').strip()
  os.environ['XLA_FLAGS'] = flags


def _collectives_of(compiled):
  colls = parse_collectives(compiled.as_text())
  return ({k: len(v) for k, v in sorted(colls.items())},
          sum(sum(v) for v in colls.values()))


def _time_min(fn, iters: int) -> float:
  import numpy as np
  times = []
  for i in range(iters):
    t0 = time.perf_counter()
    np.asarray(fn(i))
    times.append(time.perf_counter() - t0)
  return min(times)


def build_decode(model, cfg, batch, sample_m, steps, mesh, tp_vars=None):
  from svdd import mdlm

  if tp_vars is not None:
    vm, vv = tp_vars
    value = (lambda variables, tok: vm.apply(
        variables, mdlm.transform_samples(tok)), vv)
    return model.controlled_sampler(value, batch, sample_M=sample_m,
                                    num_steps=steps, mesh=mesh, tp=True)
  from svdd import rewards
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  value_fn = lambda tok: reward_fn(mdlm.transform_samples(tok))
  return model.controlled_sampler(value_fn, batch, sample_M=sample_m,
                                  num_steps=steps, mesh=mesh)


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument('--devices', type=int, default=0,
                  help='mesh size (0 = all available)')
  ap.add_argument('--virtual', action='store_true',
                  help='force an n-device virtual CPU mesh (wiring '
                       'validation on a 1-chip box)')
  ap.add_argument('--small', action='store_true',
                  help='tiny shapes (implied by --virtual)')
  ap.add_argument('--iters', type=int, default=3)
  ap.add_argument('--batch_per_chip', type=int, default=64,
                  help='decode batch rows per chip (flagship: 64/chip '
                       'x 8 = 512, the BENCH shape)')
  ap.add_argument('--sample_M', type=int, default=10)
  ap.add_argument('--steps', type=int, default=128)
  ap.add_argument('--skip_single_chip_ref', action='store_true',
                  help='skip the 1-device reference runs (halves '
                       'runtime; efficiency fields become null)')
  args = ap.parse_args()
  if args.virtual:
    args.small = True
    _force_virtual_cpu(args.devices or 8)

  import jax
  import jax.numpy as jnp
  import numpy as np

  from svdd import utils
  utils.enable_compile_cache()

  from svdd.config import dna_config, tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.models.enformer import EnformerValueModel
  from svdd.parallel import mesh as M
  from svdd.train import diffusion as train_diff

  n = args.devices or len(jax.devices())
  devices = jax.devices()[:n]
  if args.small:
    args.sample_M, args.steps = 4, 8
    args.batch_per_chip = 4

  results = []

  def emit(config, n_dev, seqs_per_chip, colls, coll_bytes,
           eff=None, invariant=None):
    line = {
        'config': config, 'devices': n_dev,
        'value': round(seqs_per_chip, 3), 'unit': 'seqs/sec/chip',
        'scaling_efficiency': (round(eff, 3) if eff is not None
                               else None),
        'collectives_per_step': colls,
        'collective_bytes_per_step': coll_bytes,
        'invariant': invariant,
    }
    results.append(line)
    print(json.dumps(line), flush=True)

  def decode_throughput(n_dev, tp=False):
    """seqs/sec/chip of guided decode on an n_dev mesh (+HLO audit)."""
    model_axis = 2 if (tp and n_dev % 2 == 0) else 1
    mesh = M.make_mesh(data=n_dev // model_axis, model=model_axis,
                       devices=devices[:n_dev])
    cfg = (tiny_test_config('dna') if args.small else dna_config())
    batch = args.batch_per_chip * n_dev
    cfg.sampling.steps = args.steps
    model = Diffusion(cfg, rng=jax.random.key(0))
    tp_vars = None
    if tp:
      if args.small:
        vm = EnformerValueModel(
            n_tasks=1, n_conv=3, channels=2 * model_axis * 64,
            n_transformers=2, n_heads=model_axis, key_len=8)
      else:
        vm = EnformerValueModel(n_tasks=1, compute_dtype=jnp.bfloat16)
      vv = jax.jit(vm.init)(jax.random.key(6),
                            jnp.zeros((1, cfg.model.length, 4)))
      tp_vars = (vm, M.tp_shard_value_params(vv, mesh))
    sampler = build_decode(model, cfg, batch, args.sample_M,
                           args.steps, mesh, tp_vars)
    with mesh:
      compiled = sampler.jitted_fn.lower(
          *sampler.default_args, jax.random.key(0)).compile()
      np.asarray(sampler(jax.random.key(0)).samples)   # warmup
      dt = _time_min(
          lambda i: sampler(jax.random.fold_in(
              jax.random.key(1), i)).samples, args.iters)
    colls, coll_bytes = _collectives_of(compiled)
    return batch / dt / n_dev, colls, coll_bytes

  def train_throughput(n_dev, fsdp):
    mesh = M.make_mesh(data=n_dev, model=1, devices=devices[:n_dev])
    cfg = (tiny_test_config('dna') if args.small else dna_config())
    cfg.parallel.fsdp = fsdp
    batch = (8 if args.small else 64) * n_dev
    cfg.loader.batch_size = batch
    model = Diffusion(cfg, rng=jax.random.key(0))
    trainer = train_diff.Trainer(model, cfg, mesh=mesh)
    state = trainer.init_or_restore(jax.random.key(1))
    data = {
        'seqs': jnp.zeros((batch, cfg.model.length), jnp.int32),
        'attention_mask': jnp.ones((batch, cfg.model.length)),
    }
    with mesh:
      sharded = trainer._put(data)
      compiled = trainer.train_step.lower(state, sharded).compile()
      state, loss = trainer.train_step(state, sharded)   # warmup
      np.asarray(loss)
      times = []
      for _ in range(args.iters):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, sharded)
        np.asarray(loss)
        times.append(time.perf_counter() - t0)
    colls, coll_bytes = _collectives_of(compiled)
    return batch / min(times) / n_dev, colls, coll_bytes

  ref = {}
  if not args.skip_single_chip_ref:
    for name, fn in (
        ('decode_candidate_dp', lambda: decode_throughput(1)),
        ('dp_train', lambda: train_throughput(1, False))):
      v, _, _ = fn()
      ref[name] = v
    ref['decode_weight_tp'] = ref['decode_candidate_dp']
    ref['fsdp_train'] = ref['dp_train']

  # ---- candidate-sharded decode: MUST be collective-free ----------
  v, colls, cb = decode_throughput(n)
  assert not colls, f'candidate-sharded decode has collectives {colls}'
  emit('decode_candidate_dp', n, v, colls, cb,
       eff=(v / ref['decode_candidate_dp'] if ref else None),
       invariant='PASS: zero collectives/step')

  # ---- Megatron weight-TP decode: all-reduce only ------------------
  v, colls, cb = decode_throughput(n, tp=True)
  extra = [k for k in colls if k != 'all-reduce']
  assert not extra, f'weight-TP decode has non-all-reduce kinds {extra}'
  emit('decode_weight_tp', n, v, colls, cb,
       eff=(v / ref['decode_weight_tp'] if ref else None),
       invariant='PASS: all-reduce is the only collective')

  # ---- DP train: grad all-reduce only ------------------------------
  v, colls, cb = train_throughput(n, fsdp=False)
  extra = [k for k in colls if k != 'all-reduce']
  assert not extra, f'DP train has non-all-reduce kinds {extra}'
  emit('dp_train', n, v, colls, cb,
       eff=(v / ref['dp_train'] if ref else None),
       invariant='PASS: grad all-reduce only')

  # ---- FSDP train: report the breakdown (no kind invariant) --------
  v, colls, cb = train_throughput(n, fsdp=True)
  unrec = [k for k in colls if k.startswith('UNRECOGNIZED')]
  assert not unrec, f'FSDP train has unrecognized collectives {unrec}'
  emit('fsdp_train', n, v, colls, cb,
       eff=(v / ref['fsdp_train'] if ref else None),
       invariant='PASS: all collective kinds recognized')


if __name__ == '__main__':
  main()
