"""One-command real-artifact parity harness (VERDICT r1 item 7).

Points at the reference's artifact/data layout, imports the torch
diffusion/value/oracle checkpoints (svdd/importers), runs all six
decode CLIs, and prints the eval/report.py quantile table against the
reference's shipped numbers (BASELINE.md).

  # real artifacts (reference allmodels/model_load.py layout under
  # SVDD_ARTIFACTS_DIR, Gosai/UTR CSVs under SVDD_DATA_DIR):
  python scripts/parity_harness.py --task dna

  # offline smoke on generated mock torch checkpoints (RNA-size):
  python scripts/parity_harness.py --make_fixtures --task rna \
      --num_steps 8 --batch_size 8 --sample_M 2

Artifact search (reference names, Enformer.py:76-133 + README.md:16-31):
  {task}_Diffusion*/ *.ckpt          Lightning diffusion ckpt
  DNA_value*/ | RNA_MRL_value*/ *.pt value net (trainer.py dict)
  {task}_evaluation*/ *.ckpt         grelu LightningModel eval oracle
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from svdd import utils

LOGGER = utils.get_logger('parity_harness')


def find_artifact(root: str, patterns: list[str]) -> str | None:
  for pat in patterns:
    hits = sorted(glob.glob(os.path.join(root, pat)))
    if hits:
      return hits[0]
  return None


def resolve_artifacts(root: str, task: str) -> dict:
  """Map the reference's artifact layout to checkpoint paths."""
  if task == 'dna':
    return {
        'diffusion': find_artifact(root, [
            'DNA_Diffusion*/last.ckpt', 'DNA_Diffusion*/*.ckpt']),
        'value': find_artifact(root, [
            'DNA_value*/*.pt', 'DNA_Value*/*.pt']),
        'oracle': find_artifact(root, [
            'DNA_evaluation*/model.ckpt', 'DNA_evaluation*/*.ckpt']),
    }
  return {
      'diffusion': find_artifact(root, [
          'RNA_Diffusion*/best.ckpt', 'RNA_Diffusion*/*.ckpt']),
      'value': find_artifact(root, [
          'RNA_MRL_value*/*.pt', 'RNA_Value*/*.pt']),
      'oracle': find_artifact(root, [
          'RNA_evaluation*/model.ckpt', 'RNA_evaluation*/*.ckpt']),
  }


def make_fixtures(root: str, task: str) -> None:
  """Generate mock torch checkpoints in the reference's layout so the
  harness runs end-to-end offline (real artifacts are wandb-gated)."""
  import torch
  import types
  sys.path.insert(0, os.path.join(os.path.dirname(
      os.path.dirname(os.path.abspath(__file__))), 'tests'))
  import torch_mirrors as tm

  assert task == 'rna', 'fixtures are RNA-size (CPU-friendly)'
  # diffusion: the reference-layout CNNModel mirror at the RNA config
  # (configs_gosai_rna/model/dnaconv.yaml: hidden 128, 4 stacks)
  args = types.SimpleNamespace(clean_data=False, hidden_dim=128,
                               num_cnn_stacks=4, dropout=0.0,
                               cls_free_guidance=False)
  torch.manual_seed(0)
  cnn = tm.CNNModel(args, alphabet_size=5, num_cls=3)
  d = os.path.join(root, 'RNA_Diffusion:v0')
  os.makedirs(d, exist_ok=True)
  torch.save({'state_dict': {'backbone.' + k: v for k, v in
                             cnn.state_dict().items()}},
             os.path.join(d, 'best.ckpt'))

  torch.manual_seed(1)
  value = tm.make_rna_value_mirror()
  tm.randomize_state_dict(value, seed=1)
  d = os.path.join(root, 'RNA_MRL_value:v0')
  os.makedirs(d, exist_ok=True)
  torch.save({'model_state_dict': value.state_dict()},
             os.path.join(d, 'rna_MRL_diffusion_convgru_fixture.pt'))

  torch.manual_seed(2)
  oracle = tm.make_rna_value_mirror()
  tm.randomize_state_dict(oracle, seed=2)
  d = os.path.join(root, 'RNA_evaluation:v0')
  os.makedirs(d, exist_ok=True)
  torch.save({'state_dict': {'model.' + k: v for k, v in
                             oracle.state_dict().items()}},
             os.path.join(d, 'model.ckpt'))
  LOGGER.info('fixtures written under %s', root)


ALGOS = ('mc', 'tweedie', 'TDS', 'DPS', 'DG', 'classfier')


def run_all(args) -> list[str]:
  from svdd.cli import common
  paths = resolve_artifacts(args.artifacts_dir, args.task)
  for kind, p in paths.items():
    if p is None:
      LOGGER.warning('no %s checkpoint found under %s (random init '
                     'will be used)', kind, args.artifacts_dir)
    else:
      LOGGER.info('%s checkpoint: %s', kind, p)

  reward_name = 'HepG2' if args.task == 'dna' else 'MRL'
  base_flags = [
      '--task', args.task, '--reward_name', reward_name,
      '--batch_size', str(args.batch_size),
      '--val_batch_num', str(args.val_batch_num),
      '--sample_M', str(args.sample_M),
      '--seed', str(args.seed),
      '--out_dir', args.out_dir,
  ]
  if args.num_steps:
    base_flags += ['--num_steps', str(args.num_steps)]
  if paths['diffusion']:
    base_flags += ['--diffusion_checkpoint_path', paths['diffusion']]
  if paths['value']:
    base_flags += ['--load_checkpoint_path', paths['value']]
  if paths['oracle']:
    base_flags += ['--reward_checkpoint_path', paths['oracle']]

  outputs = []
  selected = [a for a in ALGOS if a in args.algos.split(',')] \
      if args.algos != 'all' else list(ALGOS)
  for algo in selected:
    if algo == 'mc':
      from svdd.cli import decode as cli
      extra, suffix = [], ''
    elif algo == 'tweedie':
      from svdd.cli import decode_tweedie as cli
      extra, suffix = ['--tweedie', 'True'], '_tw'
    elif algo == 'TDS':
      from svdd.cli import decode_TDS as cli
      extra, suffix = ['--alpha', str(args.alpha)], '_TDS'
    elif algo == 'DPS':
      from svdd.cli import decode_DPS as cli
      extra, suffix = ['--guidance_scale',
                       str(args.guidance_scale)], '_DPS'
    elif algo == 'DG':
      from svdd.cli import decode_DPS as cli
      extra, suffix = ['--guidance_scale',
                       str(args.guidance_scale)], '_DG'
    else:
      from svdd.cli import decode_classfier as cli
      extra, suffix = ['--guidance_scale', '1.0'], '-classfier'

    parser = common.make_parser(f'parity:{algo}')
    if algo == 'tweedie':
      parser.add_argument('--tweedie', type=str, default='True')
    elif algo == 'TDS':
      parser.add_argument('--alpha', type=float, default=0.5)
    elif algo in ('DPS', 'DG', 'classfier'):
      parser.add_argument('--guidance_scale', type=float, default=1.0)
    cli_args = parser.parse_args(base_flags + extra)
    LOGGER.info('=== running decode[%s] ===', algo)
    try:
      if algo == 'DG':
        cli.run(cli_args, suffix='_DG')
      else:
        cli.run(cli_args)
      outputs.append(os.path.join(
          args.out_dir,
          f'{args.task}-{reward_name}{suffix}.npz'))
    except Exception as exc:                       # noqa: BLE001
      LOGGER.error('decode[%s] failed: %s', algo, exc)
  return outputs


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--task', default='dna', choices=['dna', 'rna'])
  p.add_argument('--artifacts_dir',
                 default=os.environ.get('SVDD_ARTIFACTS_DIR',
                                        './artifacts'))
  p.add_argument('--make_fixtures', action='store_true', default=False)
  p.add_argument('--batch_size', type=int, default=256)
  p.add_argument('--val_batch_num', type=int, default=1)
  p.add_argument('--sample_M', type=int, default=10)
  p.add_argument('--num_steps', type=int, default=None)
  p.add_argument('--seed', type=int, default=44)
  p.add_argument('--alpha', type=float, default=0.5)
  p.add_argument('--guidance_scale', type=float, default=1e5)
  p.add_argument('--out_dir', default='./log/parity')
  p.add_argument('--algos', default='all',
                 help="comma list of mc,tweedie,TDS,DPS,DG,classfier")
  args = p.parse_args()

  if args.make_fixtures:
    make_fixtures(args.artifacts_dir, args.task)

  outputs = run_all(args)

  from svdd.eval.report import report_file
  print('\n===== parity report (reference numbers from BASELINE.md'
        ' in brackets) =====')
  for path in outputs:
    if os.path.exists(path):
      print(report_file(path))


if __name__ == '__main__':
  main()
