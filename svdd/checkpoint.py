"""Plain pytree checkpoint helpers (orbax) + torch-checkpoint import.

Replaces the reference's three checkpoint formats (Lightning ckpts,
grelu LightningModel ckpts, hand-rolled torch dicts — SURVEY.md §5)
with one orbax pytree format, plus a one-way importer for the
reference's torch pickles (decode.py:97-104, Enformer.py:92-133).
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def orbax():
  """orbax.checkpoint, imported on first use: only checkpoint save and
  restore need it, so hosts without it still decode and train."""
  try:
    import orbax.checkpoint as ocp
  except ImportError as e:
    raise ImportError(
        'checkpoint save/restore needs the orbax-checkpoint package, '
        'which is not installed on this host') from e
  return ocp


def save_pytree(path: str, tree: Any) -> None:
  ocp = orbax()
  path = os.path.abspath(path)
  ckpt = ocp.StandardCheckpointer()
  ckpt.save(path, tree, force=True)
  ckpt.wait_until_finished()


def load_pytree(path: str, template: Any) -> Any:
  ocp = orbax()
  path = os.path.abspath(path)
  ckpt = ocp.StandardCheckpointer()
  return ckpt.restore(path, target=template)


def import_torch_state_dict(path: str, key: str | None = None) -> dict:
  """Load a torch pickle checkpoint to a flat {name: np.ndarray} dict.

  Handles the reference's formats: Lightning ckpts ('state_dict'),
  value-net trainer dicts ('model_state_dict', trainer.py:73-96), and
  raw state dicts. Conversion to a flax param tree is model-specific —
  see the importers in svdd/importers/.
  """
  import torch
  obj = torch.load(path, map_location='cpu', weights_only=False)
  if key is None:
    for k in ('state_dict', 'model_state_dict'):
      if isinstance(obj, dict) and k in obj:
        obj = obj[k]
        break
  elif key:
    obj = obj[key]
  return {name: np.asarray(t.detach().cpu().numpy())
          for name, t in obj.items()
          if hasattr(t, 'detach')}
