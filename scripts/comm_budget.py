"""Communication-budget audit: HLO-counted collective traffic per
parallel strategy on the virtual 8-device mesh.

The reference's only inter-device traffic is the NCCL gradient
all-reduce inserted by Lightning DDP/FSDP (SURVEY.md §2.2). Here every
strategy's per-step collective volume is counted from the ACTUAL
compiled HLO (post-SPMD-partitioning), not estimated — the same
methodology as the gpipe all-gather-free test
(tests/test_parallel.py::test_gpipe_matches_sequential_forward_and_grad).

Usage:  python scripts/comm_budget.py [--devices 8] [--json]

Collectives inside a `while` (lax.scan) body appear once in the HLO
and execute once per step — counts below are per-step for scanned
programs. Volumes scale linearly in the sharded batch/param dims; the
flagship-shape projection is printed alongside the measured shape.
"""

from __future__ import annotations

import argparse
import json
import re
import sys


def _force_virtual_cpu(n: int) -> None:
  import os
  os.environ['JAX_PLATFORMS'] = 'cpu'
  flags = os.environ.get('XLA_FLAGS', '')
  pat = re.compile(r'--xla_force_host_platform_device_count=(\d+)')
  if pat.search(flags):
    flags = pat.sub(f'--xla_force_host_platform_device_count={n}', flags)
  else:
    flags = (flags + f' --xla_force_host_platform_device_count={n}').strip()
  os.environ['XLA_FLAGS'] = flags


_DTYPE_BYTES = {'f64': 8, 'f32': 4, 'f16': 2, 'bf16': 2, 's64': 8,
                's32': 4, 'u64': 8, 'u32': 4, 's16': 2, 'u16': 2,
                's8': 1, 'u8': 1, 'pred': 1, 'c64': 8, 'c128': 16}

_SHAPE_RE = re.compile(r'(f64|f32|f16|bf16|s64|s32|u64|u32|s16|u16|s8|u8'
                       r'|pred|c64|c128)\[([0-9,]*)\]')
# every HLO collective opcode (longest-first so alternation can't
# truncate a match); send/recv are the point-to-point pair
_KNOWN_COLLECTIVES = (
    'ragged-all-to-all', 'collective-broadcast', 'collective-permute',
    'reduce-scatter', 'all-reduce', 'all-gather', 'all-to-all',
    'send', 'recv')
_COLL_RE = re.compile(
    r'= *((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\][^ ]*)) *'
    r'(' + '|'.join(_KNOWN_COLLECTIVES) + r')'
    r'(-start)?\(')
# audit net: ANY op whose mnemonic smells like communication; kinds
# caught here but not in _KNOWN_COLLECTIVES are reported as
# 'UNRECOGNIZED:*' so a zero-collectives verdict can't be an artifact
# of an incomplete kind list (ADVICE r2)
_ANY_COLL_RE = re.compile(
    r'= *(?:\([^)]*\)|[a-z0-9]+\[[^\]]*\][^ ]*) *'
    r'([a-z][a-z0-9-]*(?:all-to-all|all-reduce|all-gather|collective|'
    r'permute|reduce-scatter)[a-z0-9-]*|send|recv)\(')


def _shape_bytes(shape_str: str) -> int:
  total = 0
  for dtype, dims in _SHAPE_RE.findall(shape_str):
    n = 1
    for d in dims.split(','):
      if d:
        n *= int(d)
    total += n * _DTYPE_BYTES[dtype]
  return total


def _result_bytes(shape_str: str, is_start: bool) -> int:
  """Bytes of what actually MOVES. Async `-start` ops return an
  (operand, result, ...) tuple — counting the whole tuple would
  overcount by the aliased operand buffer (ADVICE r2); the result is
  the second component."""
  if is_start:
    comps = _SHAPE_RE.findall(shape_str)
    if len(comps) >= 2:
      dtype, dims = comps[1]
      n = 1
      for d in dims.split(','):
        if d:
          n *= int(d)
      return n * _DTYPE_BYTES[dtype]
  return _shape_bytes(shape_str)


def parse_collectives(hlo_text: str):
  """Return {op_kind: [bytes, ...]} for every collective in the HLO.
  Bytes = the op's RESULT shape (what actually moves, post-partition,
  per participating device). Communication-looking ops of a kind not
  in _KNOWN_COLLECTIVES land under 'UNRECOGNIZED:<name>' with bytes 0
  so they can't silently escape the audit."""
  out: dict[str, list[int]] = {}
  spans = set()
  for m in _COLL_RE.finditer(hlo_text):
    shape, kind, start = m.group(1), m.group(2), m.group(3)
    out.setdefault(kind, []).append(_result_bytes(shape, bool(start)))
    spans.add(m.start())
  for m in _ANY_COLL_RE.finditer(hlo_text):
    if m.start() in spans:
      continue
    name = m.group(1)
    base = name
    for suffix in ('-start', '-done'):
      base = base[:-len(suffix)] if base.endswith(suffix) else base
    if base in _KNOWN_COLLECTIVES or name.endswith('-done'):
      # -done ops complete a counted -start; don't double-count
      continue
    out.setdefault(f'UNRECOGNIZED:{name}', []).append(0)
  return out


def summarize(name: str, compiled, note: str = ''):
  text = compiled.as_text()
  colls = parse_collectives(text)
  total = sum(sum(v) for v in colls.values())
  counts = {k: len(v) for k, v in sorted(colls.items())}
  bytes_by = {k: sum(v) for k, v in sorted(colls.items())}
  return {'scenario': name, 'collectives': counts,
          'bytes_per_kind': bytes_by, 'total_bytes': total, 'note': note}


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument('--devices', type=int, default=8)
  ap.add_argument('--json', action='store_true')
  args = ap.parse_args()

  _force_virtual_cpu(args.devices)
  import jax
  import jax.numpy as jnp
  jax.config.update('jax_platforms', 'cpu')

  from svdd import mdlm
  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.models.enformer import EnformerValueModel
  from svdd.parallel import mesh as M
  from svdd.train import diffusion as train_diff

  n = args.devices
  devices = jax.devices()[:n]
  results = []

  # ---- DP and FSDP training step (CNN diffusion, B=8/device) ----
  for fsdp in (False, True):
    mesh = M.make_mesh(data=n, model=1, devices=devices)
    cfg = tiny_test_config('dna')
    cfg.parallel.fsdp = fsdp
    if fsdp:
      # keep the default min_size threshold (biases/norm scales stay
      # replicated, as in a real run) but make the conv kernels large
      # enough to shard — the representative FSDP traffic pattern
      cfg.model.hidden_dim = 64
    cfg.loader.batch_size = 8 * n
    model = Diffusion(cfg, rng=jax.random.key(0))
    trainer = train_diff.Trainer(model, cfg, mesh=mesh)
    state = trainer.init_or_restore(jax.random.key(1))
    batch = {
        'seqs': jnp.zeros((cfg.loader.batch_size, cfg.model.length),
                          jnp.int32),
        'attention_mask': jnp.ones(
            (cfg.loader.batch_size, cfg.model.length)),
    }
    with mesh:
      sharded = trainer._put(batch)
      compiled = trainer.train_step.lower(state, sharded).compile()
    results.append(summarize(
        'fsdp_train' if fsdp else 'dp_train', compiled,
        note=('params+opt sharded over data; all-gather at use, '
              'reduce-scatter on grads (ZeRO style)') if fsdp else
             'grad all-reduce only — the NCCL-DDP equivalent'))

  # ---- guided decode, candidate-dim sharding (B*M over all devices) --
  mesh = M.make_mesh(data=n, model=1, devices=devices)
  cfg = tiny_test_config('dna')
  cfg.loader.batch_size = 2 * n
  model = Diffusion(cfg, rng=jax.random.key(0))
  from svdd import rewards
  reward_fn = rewards.synthetic_motif_oracle(cfg.model.length)
  value_fn = lambda tok: reward_fn(mdlm.transform_samples(tok))
  sampler = model.controlled_sampler(
      value_fn, cfg.loader.batch_size, sample_M=4, num_steps=2,
      mesh=mesh)
  with mesh:
    compiled = sampler.jitted_fn.lower(
        *sampler.default_args, jax.random.key(2)).compile()
  results.append(summarize(
      'svdd_mc_decode_candidate_dp', compiled,
      note='B*M candidates sharded over data axis; per-row argmax over '
           'M stays shard-local (M divides the per-device block)'))

  # ---- guided decode, Megatron weight-TP value net over model axis ---
  model_axis = 2 if n % 2 == 0 else 1
  mesh = M.make_mesh(data=n // model_axis, model=model_axis,
                     devices=devices)
  vm = EnformerValueModel(n_tasks=1, n_conv=3,
                          channels=2 * model_axis * 64,
                          n_transformers=2, n_heads=model_axis,
                          key_len=8)
  vv = jax.jit(vm.init)(jax.random.key(6),
                        jnp.zeros((1, cfg.model.length, 4)))
  tp_vars = M.tp_shard_value_params(vv, mesh)
  value_apply = lambda variables, tok: vm.apply(
      variables, mdlm.transform_samples(tok))
  tp_sampler = model.controlled_sampler(
      (value_apply, tp_vars), cfg.loader.batch_size, sample_M=4,
      num_steps=2, mesh=mesh, tp=True)
  with mesh:
    compiled = tp_sampler.jitted_fn.lower(
        *tp_sampler.default_args, jax.random.key(7)).compile()
  results.append(summarize(
      'svdd_mc_decode_weight_tp', compiled,
      note=f'model axis={model_axis}: column/row-split Enformer matmuls;'
           ' one all-reduce per Megatron pair per step'))

  # ---- report ----
  if args.json:
    print(json.dumps(results, indent=2))
    return
  w = max(len(r['scenario']) for r in results)
  print(f'{"scenario":<{w}}  {"total B/step":>12}  collectives')
  for r in results:
    kinds = ', '.join(f'{k}x{v} ({r["bytes_per_kind"][k]:,}B)'
                      for k, v in r['collectives'].items()) or 'NONE'
    print(f'{r["scenario"]:<{w}}  {r["total_bytes"]:>12,}  {kinds}')
    print(f'{"":<{w}}  {"":>12}  {r["note"]}')
  sys.stdout.flush()


if __name__ == '__main__':
  main()
