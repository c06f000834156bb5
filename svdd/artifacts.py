"""Model-artifact registry.

Replaces the reference's W&B artifact fetcher (reference
allmodels/model_load.py:1-22, which downloads 2 diffusion ckpts,
3 value ckpts and 3 eval oracles from a private wandb host). This
container has zero egress, so artifacts resolve from a local directory
(``SVDD_ARTIFACTS_DIR``, default ./artifacts) by the same names; the
torch-pickle originals can be converted with svdd.importers.
"""

from __future__ import annotations

import os
from typing import Dict

ARTIFACTS_DIR = os.environ.get('SVDD_ARTIFACTS_DIR', './artifacts')

# name -> (relative path, kind) mirroring model_load.py's download list
REGISTRY: Dict[str, tuple] = {
    'DNA_Diffusion': ('DNA_Diffusion/last.ckpt', 'diffusion'),
    'RNA_Diffusion': ('RNA_Diffusion/best.ckpt', 'diffusion'),
    'DNA_Value': ('DNA_Value/model.pt', 'value'),
    'RNA_Value': ('RNA_Value/model.pt', 'value'),
    'RNA_Stability_Value': ('RNA_Stability_Value/model.pt', 'value'),
    'DNA_evaluation': ('DNA_evaluation/model.ckpt', 'oracle'),
    'RNA_evaluation': ('RNA_evaluation/model.ckpt', 'oracle'),
    'RNA_Stability_oracle': ('RNA_Stability_oracle/model.pt', 'oracle'),
}


def artifact_path(name: str, version: str = 'v0') -> str:
  """Resolve an artifact name to a local path (raises with guidance if
  absent — no network fetch is possible here)."""
  if name not in REGISTRY:
    raise KeyError(f'unknown artifact {name!r}; known: '
                   f'{sorted(REGISTRY)}')
  rel, _ = REGISTRY[name]
  path = os.path.join(ARTIFACTS_DIR, f'{name}:{version}',
                      os.path.basename(rel))
  if not os.path.exists(path):
    raise FileNotFoundError(
        f'artifact {name}:{version} not found at {path}. This '
        'environment has no network egress; place the reference '
        'checkpoint there manually (reference allmodels/model_load.py '
        'downloads it from wandb) and convert with svdd.importers.')
  return path


def available_artifacts() -> Dict[str, bool]:
  out = {}
  for name in REGISTRY:
    try:
      artifact_path(name)
      out[name] = True
    except (FileNotFoundError, KeyError):
      out[name] = False
  return out
