"""Fault-tolerance under fire at the flagship train config
(VERDICT r4 item 7).

Three sequential subprocess runs of cli/main_gosai.py train mode at
the full DNA config (global batch 512, bf16 CNN compute — the bench
train configuration) on hardware:

  A  train with SVDD_CRASH_AT_STEP: the process dies mid-run via
     exception propagation with the step-CKPT async
     orbax save potentially still in flight — a worker crash between
     checkpoints.
  B  resume from the same --ckpt_dir (checkpointing.resume_from_ckpt):
     restores the last COMPLETE checkpoint + fast-forwards the
     iterator state, continues to the target step.
  C  clean uninterrupted run to the target step, same seed, fresh dir.

Pin: B's logged losses at matching absolute steps equal C's (the
resume trajectory is the uninterrupted trajectory — iterator
fast-forward + checkpointed RNG make it deterministic). Metrics JSONLs
are left under --out for committing (reference resume semantics:
diffusion_gosai.py:189-277).

    python scripts/probe_resume_fire.py [--out log/resume_fire]
        [--target 3000] [--crash 1600] [--ckpt_every 500]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA_SET = ['training.accum_steps=2']   # overridden by --extra_set


def run_one(tag, out_dir, ckpt_dir, max_steps, ckpt_every, env_extra,
            expect_rc=0):
  env = dict(os.environ)
  env.update(env_extra)
  env.setdefault('SVDD_CNN_BF16', '1')
  cmd = [
      sys.executable, '-m', 'svdd.cli.main_gosai',
      '--task', 'dna', '--mode', 'train',
      '--ckpt_dir', ckpt_dir,
      '--log_dir', out_dir,
      '--max_steps', str(max_steps),
      '--no_sample_eval',
      '--set',
      f'checkpointing.every_n_steps={ckpt_every}',
      'eval.val_check_interval=1000000',
  ] + EXTRA_SET
  print(f'[{tag}] {" ".join(cmd)}', flush=True)
  r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                     text=True, timeout=3600)
  log_path = os.path.join(out_dir, f'{tag}.stdout.log')
  os.makedirs(out_dir, exist_ok=True)
  with open(log_path, 'w') as f:
    f.write(r.stdout + '\n--- stderr ---\n' + r.stderr)
  print(f'[{tag}] rc={r.returncode} (log: {log_path})', flush=True)
  tail = '\n'.join((r.stderr or r.stdout).splitlines()[-6:])
  print(tail, flush=True)
  if expect_rc == 0 and r.returncode != 0:
    raise SystemExit(f'{tag} failed rc={r.returncode}')
  if expect_rc != 0 and r.returncode == 0:
    raise SystemExit(f'{tag} was expected to crash but exited 0')
  return r


def read_losses(log_dir):
  rows = {}
  for name in os.listdir(log_dir):
    if not name.endswith('.jsonl'):
      continue
    with open(os.path.join(log_dir, name)) as f:
      for line in f:
        row = json.loads(line)
        if 'train/loss' in row and '_step' in row:
          rows[int(row['_step'])] = float(row['train/loss'])
  return rows


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--out', default='log/resume_fire')
  p.add_argument('--target', type=int, default=3000)
  p.add_argument('--crash', type=int, default=1600)
  p.add_argument('--ckpt_every', type=int, default=500)
  p.add_argument('--keep', action='store_true',
                 help='keep checkpoint dirs (large) after the probe')
  p.add_argument('--extra_set', nargs='*', default=None,
                 help='extra dotted config overrides (replaces the '
                      'default training.accum_steps=2) — used by the '
                      'tiny CPU self-validation of this probe')
  args = p.parse_args()
  global EXTRA_SET
  if args.extra_set is not None:
    EXTRA_SET = list(args.extra_set)
  out = os.path.join(REPO, args.out)
  shutil.rmtree(out, ignore_errors=True)
  ckpt_ab = os.path.join(out, 'ckpt_ab')
  ckpt_c = os.path.join(out, 'ckpt_c')

  run_one('A_crash', os.path.join(out, 'runA'), ckpt_ab, args.target,
          args.ckpt_every, {'SVDD_CRASH_AT_STEP': str(args.crash)},
          expect_rc=1)
  run_one('B_resume', os.path.join(out, 'runB'), ckpt_ab,
          args.target, args.ckpt_every, {})
  run_one('C_clean', os.path.join(out, 'runC'), ckpt_c, args.target,
          args.ckpt_every, {})

  la = read_losses(os.path.join(out, 'runA'))
  lb = read_losses(os.path.join(out, 'runB'))
  lc = read_losses(os.path.join(out, 'runC'))
  print(f'A logged {len(la)} loss rows (to crash at ~{args.crash}); '
        f'B {len(lb)}; C {len(lc)}', flush=True)

  # B resumed from the last complete checkpoint (<= crash step) and
  # its continued trajectory must MATCH the clean run at the same
  # absolute steps
  resumed_steps = sorted(lb)
  assert resumed_steps, 'resume run logged nothing'
  common = sorted(set(lb) & set(lc))
  post = [s for s in common if s > args.crash - args.ckpt_every]
  assert post, f'no post-resume steps to compare: B={resumed_steps[:5]}'
  diffs = [abs(lb[s] - lc[s]) for s in post]
  print('post-resume steps compared:', post, flush=True)
  print('B-vs-C loss |diff|:',
        [f'{d:.2e}' for d in diffs], flush=True)
  worst = max(diffs)
  verdict = 'EXACT' if worst == 0.0 else (
      'CONTINUOUS' if worst < 5e-3 else 'DIVERGED')
  print(f'resume-under-fire: {verdict} (max |loss diff| {worst:.3e} '
        f'over steps {post[0]}..{post[-1]})', flush=True)
  with open(os.path.join(out, 'summary.json'), 'w') as f:
    json.dump({'verdict': verdict, 'max_loss_diff': worst,
               'steps_compared': post,
               'b_losses': {str(s): lb[s] for s in post},
               'c_losses': {str(s): lc[s] for s in post},
               'crash_step': args.crash,
               'ckpt_every': args.ckpt_every,
               'target': args.target}, f, indent=1)
  if not args.keep:
    shutil.rmtree(ckpt_ab, ignore_errors=True)
    shutil.rmtree(ckpt_c, ignore_errors=True)
  if verdict == 'DIVERGED':
    raise SystemExit(1)


if __name__ == '__main__':
  main()
