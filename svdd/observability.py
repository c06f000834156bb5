"""Observability: metrics logging, step timing, profiler traces.

The reference wires wandb into every entry script (decode.py:55-62,
train.py:70-77, trainer.py:140-149) and has NO tracing/profiling
(SURVEY.md §5: only commented-out time.time() probes). This module
provides the upgrade:

  MetricsLogger  — JSONL metrics sink with optional wandb mirroring
                   (wandb used only if importable+configured; this
                   container has no egress)
  StepTimer      — per-step wall/device timing with summary stats
  profile_trace  — jax.profiler context writing a TensorBoard trace
  nan_guard      — jitted NaN/Inf detector for loss/grads
                   (utils.print_nans upgrade)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np


class MetricsLogger:
  """Append-only JSONL logger, drop-in where the reference calls
  wandb.log."""

  def __init__(self, log_dir: str = './log', run_name: str = 'run',
               use_wandb: bool = False, wandb_kwargs: Optional[Dict] = None):
    os.makedirs(log_dir, exist_ok=True)
    self.path = os.path.join(log_dir, f'{run_name}.metrics.jsonl')
    self._fh = open(self.path, 'a')
    self._wandb = None
    if use_wandb:
      try:
        import wandb
        self._wandb = wandb
        wandb.init(**(wandb_kwargs or {}))
      except Exception:
        self._wandb = None

  def log(self, metrics: Dict[str, Any], step: Optional[int] = None
          ) -> None:
    row = {'_time': time.time()}
    if step is not None:
      row['_step'] = int(step)
    for k, v in metrics.items():
      if isinstance(v, (jnp.ndarray, np.ndarray)):
        v = np.asarray(v)
        v = v.item() if v.size == 1 else v.tolist()
      row[k] = v
    self._fh.write(json.dumps(row) + '\n')
    self._fh.flush()
    if self._wandb is not None:
      self._wandb.log(metrics, step=step)

  def finish(self) -> None:
    self._fh.close()
    if self._wandb is not None:
      self._wandb.finish()


class StepTimer:
  """Wall-clock step timing with percentile summary (the profiling the
  reference left commented out at diffusion_gosai.py:480-497)."""

  def __init__(self):
    self.samples = []
    self._t0 = None

  def start(self) -> None:
    self._t0 = time.perf_counter()

  def stop(self, result: Any = None) -> float:
    """Blocks on ``result`` (device array) before stopping the clock."""
    if result is not None:
      jax.block_until_ready(result)
    dt = time.perf_counter() - self._t0
    self.samples.append(dt)
    return dt

  def summary(self) -> Dict[str, float]:
    arr = np.asarray(self.samples)
    if arr.size == 0:
      return {}
    return {'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p90_s': float(np.percentile(arr, 90)),
            'steps': int(arr.size)}


@contextlib.contextmanager
def profile_trace(log_dir: str = './profile') -> Iterator[None]:
  """jax.profiler trace context (view in TensorBoard/xprof)."""
  jax.profiler.start_trace(log_dir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()


def nan_guard(tree: Any, name: str = 'tree') -> jnp.ndarray:
  """True iff any leaf contains NaN/Inf; logs via debug callback
  (upgrade of utils.print_nans, reference utils.py:34-36)."""
  flags = [jnp.logical_not(jnp.isfinite(x)).any()
           for x in jax.tree.leaves(tree)
           if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)]
  any_bad = jnp.any(jnp.stack(flags)) if flags else jnp.asarray(False)

  def _report(bad):
    if bad:
      print(f'[nan_guard] non-finite values detected in {name}')
  jax.debug.callback(_report, any_bad)
  return any_bad
