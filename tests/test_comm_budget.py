"""Unit tests for the HLO collective parser behind
scripts/comm_budget.py (the communication-budget audit)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                'scripts'))

from comm_budget import _shape_bytes, parse_collectives  # noqa: E402


def test_shape_bytes_simple_and_tuple():
  assert _shape_bytes('f32[8,64]{1,0}') == 8 * 64 * 4
  assert _shape_bytes('bf16[128]') == 128 * 2
  # tuple shapes (e.g. all-reduce of several operands) sum components
  assert _shape_bytes('(f32[4,4]{1,0}, bf16[8]{0})') == 64 + 16
  # scalars have an empty dims list
  assert _shape_bytes('pred[]') == 1


def test_parse_collectives_counts_and_bytes():
  hlo = """
  ENTRY main {
    %ar = f32[16,4]{1,0} all-reduce(%x), replica_groups={}, to_apply=%add
    %ag = bf16[32]{0} all-gather(%y), dimensions={0}
    %cp = f32[8]{0} collective-permute(%z), source_target_pairs={{0,1}}
    %ars = (f32[4]{0}, f32[4]{0}) all-reduce-start(%a, %b)
    %dot = f32[16,16]{1,0} dot(%p, %q)
  }
  """
  out = parse_collectives(hlo)
  # -start counts the RESULT tuple component only (the operand buffer
  # is aliased, not moved — ADVICE r2)
  assert out['all-reduce'] == [16 * 4 * 4, 4 * 4]
  assert out['all-gather'] == [32 * 2]
  assert out['collective-permute'] == [8 * 4]
  assert 'all-to-all' not in out
  # non-collective ops (dot) never counted
  assert sum(len(v) for v in out.values()) == 4


def test_parse_collectives_async_start_result_component():
  """all-gather-start returns (operand, result): the moved bytes are
  the RESULT (gathered) component, 8x the operand on 8 devices."""
  hlo = """
    %ags = (bf16[16]{0}, bf16[128]{0}) all-gather-start(%y), dimensions={0}
    %agd = bf16[128]{0} all-gather-done(%ags)
    %cps = (f32[8]{0}, f32[8]{0}) collective-permute-start(%z)
  """
  out = parse_collectives(hlo)
  assert out['all-gather'] == [128 * 2]       # result, not 16+128
  assert out['collective-permute'] == [8 * 4]
  # -done completes the counted -start: never double-counted
  assert sum(len(v) for v in out.values()) == 2


def test_parse_collectives_flags_unrecognized_kinds():
  """A communication-looking op outside the known-kind list must be
  surfaced, not silently ignored — a 'zero collectives' verdict is
  only as strong as the kind list (ADVICE r2)."""
  hlo = """
    %cb = f32[8]{0} collective-broadcast(%x)
    %ra = f32[8]{0} ragged-all-to-all(%a, %b, %c)
    %sd = (f32[4]{0}, u32[], token[]) send(%t, %tok), channel_id=1
    %mystery = f32[8]{0} all-reduce-scatter-fancy(%y)
  """
  out = parse_collectives(hlo)
  assert out['collective-broadcast'] == [8 * 4]
  assert out['ragged-all-to-all'] == [8 * 4]
  assert 'send' in out
  unrec = [k for k in out if k.startswith('UNRECOGNIZED:')]
  assert unrec == ['UNRECOGNIZED:all-reduce-scatter-fancy']


def test_bench_multichip_virtual_wiring(tmp_path):
  """scripts/bench_multichip.py --virtual: all four strategy configs
  run on the virtual mesh, emit one JSON line each, and their HLO
  collective invariants PASS (zero collectives for candidate-sharded
  decode; all-reduce-only for TP decode / DP train)."""
  import json
  import subprocess

  env = dict(os.environ)
  env['PYTHONPATH'] = os.path.join(os.path.dirname(__file__), '..')
  out = subprocess.run(
      [sys.executable,
       os.path.join(os.path.dirname(__file__), '..', 'scripts',
                    'bench_multichip.py'),
       '--virtual', '--devices', '2', '--iters', '1',
       '--skip_single_chip_ref'],
      capture_output=True, text=True, env=env, timeout=1200)
  assert out.returncode == 0, out.stderr[-2000:]
  lines = [json.loads(l) for l in out.stdout.splitlines() if l.strip()]
  configs = {l['config']: l for l in lines}
  assert set(configs) == {'decode_candidate_dp', 'decode_weight_tp',
                          'dp_train', 'fsdp_train'}
  assert configs['decode_candidate_dp']['collectives_per_step'] == {}
  assert set(configs['decode_weight_tp']['collectives_per_step']) \
      == {'all-reduce'}
  assert set(configs['dp_train']['collectives_per_step']) \
      == {'all-reduce'}
  for l in lines:
    assert l['invariant'].startswith('PASS')
    assert l['value'] > 0
