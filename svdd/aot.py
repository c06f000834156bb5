"""AOT sampler serialization (jax.export round-trip).

The guided-decode scan is a large program whose cold jit takes minutes
(the persistent compilation cache only helps the machine that ran the
compile). For production serving the compiled sampler can instead be
exported ONCE to a StableHLO artifact and shipped: loading is a
deserialize + (cached) backend compile, and the artifact is
hermetic — no svdd source needed at load time beyond this module.

The reference has no equivalent (its torch modules re-trace eagerly
every process start); this is serving infrastructure in the spirit of
its checkpoint shipping (model_load.py: artifacts fetched once, reused
everywhere).

Usage:
    sampler = diffusion.controlled_sampler(value_fn, B, sample_M=M)
    aot.export_sampler(sampler, 'mc_b512.svddx')      # once, anywhere
    call = aot.load_sampler('mc_b512.svddx')          # on the fleet
    result = call(den_vars, extra_vars, key)

Exported artifacts embed the target platform list (default: the
exporting process's backend); loading on a different platform raises.
Shape/dtype of every argument is pinned at export time — the loader
validates on call, so a mismatched params tree fails loudly.

Known limitation (jax 0.9.0): MESH-SHARDED samplers do not round-trip
through jax.export — re-lowering the exported module trips an MLIR
verifier error in both partitioners (shardy: "sharding doesn't match
tensor rank: 0 != 1" on sdy.sharding_constraint; GSPMD: custom_call
"should have a sharding attribute of type TensorShardingPerValueAttr").
Export single-device samplers (the per-host serving case) until the
upstream round-trip is fixed; sharded programs rely on the persistent
compilation cache instead.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import jax
from jax import export as jax_export

MAGIC = b'SVDDX001'

# Bump whenever the traced sampler PROGRAMS change (new fusion, reuse
# path, kernel swap, ...): it salts the decode AOT-cache key so stale
# artifacts from older program versions are never served.
PROGRAM_REV = 5   # one plain-XLA implementation per op

# Environment switches read at trace time that change the compiled
# program; they salt the AOT-cache keys.
PROGRAM_ENV = ('SVDD_CNN_BF16', 'SVDD_VALUE_BF16', 'SVDD_REMAT_CNN_LAYERS',
               'SVDD_UNROLL_TOWER')


def program_env() -> dict:
  """The PROGRAM_ENV switches set in this process."""
  return {k: os.environ[k] for k in PROGRAM_ENV if k in os.environ}

# Pytree node types appearing in sampler signatures must be registered
# for serialization (jax.export pins arg/result treedefs in the
# artifact). Serialized names are stable identifiers — do not rename.
def _register_trees() -> None:
  from svdd.sampling.sampler import SampleResult
  try:
    jax_export.register_namedtuple_serialization(
        SampleResult, serialized_name='svdd.SampleResult')
  except ValueError:
    pass  # already registered (idempotent across repeat imports)


_register_trees()


def _avals(tree: Any):
  return jax.tree.map(
      lambda x: jax.ShapeDtypeStruct(jax.numpy.shape(x),
                                     jax.numpy.result_type(x)), tree)


def _atomic_write(path: str | os.PathLike, data: bytes) -> None:
  """Write via temp-file + rename so a killed export never leaves a
  truncated artifact poisoning the cache (MAGIC would still match but
  the payload would crash every later load)."""
  tmp = f'{path}.tmp.{os.getpid()}'
  with open(tmp, 'wb') as f:
    f.write(data)
  os.replace(tmp, path)


def export_sampler(sampler: Any, path: str | os.PathLike,
                   *, platforms: Sequence[str] | None = None) -> int:
  """Serialize a Diffusion sampler (any _jit_sampler product) to
  ``path``. Returns the artifact size in bytes.

  ``platforms``: lowering targets (e.g. ('cuda',)); default is the
  current default backend, so exporting from a CPU process targets
  CPU. Cross-platform export works without owning the hardware —
  pass ('cuda',) on any machine.
  """
  return export_fn(sampler.jitted_fn,
                   sampler.default_args + (jax.random.key(0),), path,
                   platforms=platforms)


def export_fn(fn: Callable, args: tuple, path: str | os.PathLike,
              *, platforms: Sequence[str] | None = None) -> int:
  """Serialize an arbitrary jitted callable for ``args`` (example
  values or ShapeDtypeStructs) to ``path``."""
  if not hasattr(fn, 'lower'):
    fn = jax.jit(fn)
  exp = jax_export.export(
      fn, platforms=None if platforms is None else list(platforms))(
          *_avals(args))
  data = MAGIC + exp.serialize()
  _atomic_write(path, data)
  return len(data)


def load(path: str | os.PathLike) -> Callable:
  """Deserialize an artifact; returns the callable (positional args
  exactly as exported). Raises ValueError on a bad header."""
  with open(path, 'rb') as f:
    data = f.read()
  if not data.startswith(MAGIC):
    raise ValueError(
        f'{path}: not an svdd AOT artifact (bad magic)')
  exp = jax_export.deserialize(data[len(MAGIC):])
  return exp.call


def load_sampler(path: str | os.PathLike) -> Callable:
  """Load a sampler artifact: (den_vars, extra_vars, key) -> result."""
  return load(path)


# ---------------------------------------------------------------------------
# Compiled-executable artifacts. jax.export ships STABLEHLO — portable,
# but the target still runs the XLA backend compile on first call (the
# dominant cost of a cold start: minutes for the guided scan). The
# executable artifact instead pickles the COMPILED XLA program
# (jax.experimental.serialize_executable): loading skips tracing,
# lowering AND compilation. The trade: it is locked to the exact
# backend/topology that compiled it — ship it per fleet configuration,
# like the reference ships per-GPU torch.compile caches would.
# ---------------------------------------------------------------------------

MAGIC_EXEC = b'SVDDC001'


def export_compiled(sampler: Any, path: str | os.PathLike,
                    *, key: jax.Array | None = None,
                    return_compiled: bool = False):
  """Compile a sampler (if not already cached) and serialize the XLA
  executable to ``path``. Returns the artifact size in bytes — or
  ``(size, compiled)`` with ``return_compiled=True`` so callers can run
  cost analysis on the exact exported executable without risking a
  second compile (an explicit lower().compile() is not guaranteed to
  hit the jit dispatch cache)."""
  import pickle

  from jax.experimental import serialize_executable as se

  den_vars, extra_vars = sampler.default_args
  if key is None:
    key = jax.random.key(0)
  compiled = sampler.jitted_fn.lower(den_vars, extra_vars, key).compile()
  n_dev = len(compiled.runtime_executable().local_devices())
  payload = pickle.dumps((n_dev,) + se.serialize(compiled))
  data = MAGIC_EXEC + payload
  _atomic_write(path, data)
  if return_compiled:
    return len(data), compiled
  return len(data)


def load_compiled(path: str | os.PathLike) -> Callable:
  """Load an executable artifact: (den_vars, extra_vars, key) ->
  result, with NO compile on first call. Raises ValueError on a bad
  header or a backend mismatch (XLA validates at load)."""
  import pickle

  from jax.experimental import serialize_executable as se

  with open(path, 'rb') as f:
    data = f.read()
  if not data.startswith(MAGIC_EXEC):
    raise ValueError(
        f'{path}: not an svdd compiled artifact (bad magic)')
  n_dev, blob, in_tree, out_tree = pickle.loads(data[len(MAGIC_EXEC):])
  # pin execution to the same device COUNT the program was compiled
  # for (deserialize_and_load defaults to every local device, which
  # breaks a 1-device program on a multi-device host)
  devices = jax.devices()[:n_dev]
  if len(devices) < n_dev:
    raise ValueError(
        f'{path}: compiled for {n_dev} devices, host has {len(devices)}')
  return se.deserialize_and_load(blob, in_tree, out_tree,
                                 execution_devices=devices)
