"""Sequence format converters.

Rebuild of the reference format.py (reference format.py:365
convert_input_type and friends): conversions among DNA strings, int
token indices, and one-hot arrays, with type checks. The reference's
genome-interval conversions depend on grelu genome assets that are not
part of the SVDD pipeline; the sequence-level conversions (the ones the
decode/eval paths use) are complete here.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from svdd.data.gosai import (DNA_ALPHABET, batch_dna_detokenize,
                                 dna_tokenize_batch)

SeqLike = Union[str, Sequence[str], np.ndarray]


def get_input_type(x: SeqLike) -> str:
  """'strings' | 'indices' | 'one_hot' (format.py input checks)."""
  if isinstance(x, str) or (
      isinstance(x, (list, tuple)) and x and isinstance(x[0], str)):
    return 'strings'
  arr = np.asarray(x)
  # (.., L, 4) trailing channel axis = one-hot; a float matrix with 4
  # columns also reads as a single one-hot sequence. Int matrices with
  # L==4 are still indices.
  if arr.ndim >= 3 and arr.shape[-1] == 4:
    return 'one_hot'
  if (arr.ndim == 2 and arr.shape[-1] == 4
      and np.issubdtype(arr.dtype, np.floating)):
    return 'one_hot'
  if np.issubdtype(arr.dtype, np.integer):
    return 'indices'
  raise ValueError(f'unrecognized sequence input {type(x)}')


def strings_to_indices(seqs: Union[str, Sequence[str]]) -> np.ndarray:
  if isinstance(seqs, str):
    seqs = [seqs]
  check_strings(seqs)
  return dna_tokenize_batch(list(seqs))


def indices_to_strings(tokens: np.ndarray) -> List[str]:
  tokens = np.atleast_2d(np.asarray(tokens))
  return batch_dna_detokenize(tokens)


def indices_to_one_hot(tokens: np.ndarray) -> np.ndarray:
  tokens = np.asarray(tokens)
  out = np.zeros(tokens.shape + (4,), np.float32)
  valid = (tokens >= 0) & (tokens < 4)
  np.put_along_axis(out, np.clip(tokens, 0, 3)[..., None],
                    valid[..., None].astype(np.float32), axis=-1)
  return out


def one_hot_to_indices(onehot: np.ndarray) -> np.ndarray:
  onehot = np.asarray(onehot)
  idx = onehot.argmax(-1).astype(np.int32)
  # all-zero rows (masked) -> 4, matching transform_samples' inverse
  idx = np.where(onehot.sum(-1) > 0, idx, 4)
  return idx


def convert_input_type(x: SeqLike, output_type: str):
  """Any -> any conversion (format.py convert_input_type:365)."""
  in_type = get_input_type(x)
  if in_type == output_type:
    return x
  if in_type == 'strings':
    idx = strings_to_indices(x)
  elif in_type == 'one_hot':
    idx = one_hot_to_indices(x)
  else:
    idx = np.asarray(x)
  if output_type == 'indices':
    return idx
  if output_type == 'strings':
    return indices_to_strings(idx)
  if output_type == 'one_hot':
    return indices_to_one_hot(idx)
  raise ValueError(f'unknown output type {output_type!r}')


def check_strings(seqs: Sequence[str]) -> None:
  """Alphabet check (format.py check_* helpers)."""
  ok = set(DNA_ALPHABET) | {'N'}
  for s in seqs:
    bad = set(s.upper()) - ok
    if bad:
      raise ValueError(f'invalid characters {bad} in sequence')


# ---------------------------------------------------------------------------
# Genomic intervals (format.py:31-52 + the interval branch of
# convert_input_type:365). The STRUCTURE checks and interval<->string
# resolution are asset-free; instead of grelu's genome downloads
# (unavailable offline), interval resolution takes an explicit
# {chrom: sequence} dict — point it at any locally available FASTA.
# ---------------------------------------------------------------------------


def check_intervals(df) -> bool:
  """True iff ``df`` is a genomic-interval frame: first three columns
  named chrom/start/end with string/int dtypes (format.py:31-52)."""
  try:
    import pandas as pd
    from pandas.api.types import (is_integer_dtype, is_string_dtype)
  except ImportError:
    return False
  if not hasattr(df, 'columns') or df.shape[1] < 3:
    return False
  if list(df.columns[:3]) != ['chrom', 'start', 'end']:
    return False
  chrom = df['chrom']
  return (bool(is_string_dtype(chrom)
               or isinstance(chrom.dtype, pd.CategoricalDtype))
          and is_integer_dtype(df['start'])
          and is_integer_dtype(df['end']))


def check_indices(indices) -> bool:
  """Valid integer-encoded DNA: int array, 1-2D, values in [0, 4]
  (format.py:68-87; any int dtype accepted, not only int8)."""
  arr = np.asarray(indices)
  return (np.issubdtype(arr.dtype, np.integer) and arr.ndim in (1, 2)
          and arr.size > 0 and 0 <= arr.min() and arr.max() <= 4)


def check_one_hot(one_hot) -> bool:
  """Valid one-hot: float array, 2-3D, 4 channels LAST (format.py:90-109
  checks channel-FIRST torch layout; this build is channel-last)."""
  arr = np.asarray(one_hot)
  return (np.issubdtype(arr.dtype, np.floating)
          and arr.ndim in (2, 3) and arr.shape[-1] == 4)


def intervals_to_strings(df, genome: dict) -> List[str]:
  """Resolve intervals against a {chrom: sequence-string} dict
  (the asset-free counterpart of grelu's genome-backed
  intervals_to_strings used by format.py:365). Reverse-complements
  rows whose optional 'strand' column is '-'."""
  comp = str.maketrans('ACGTN', 'TGCAN')
  out = []
  for row in df.itertuples(index=False):
    chrom, start, end = row.chrom, int(row.start), int(row.end)
    if chrom not in genome:
      raise KeyError(f'chromosome {chrom!r} not in the provided genome '
                     'dict (offline build: pass {chrom: sequence})')
    s = genome[chrom][start:end].upper()
    if getattr(row, 'strand', '+') == '-':
      s = s.translate(comp)[::-1]
    out.append(s)
  return out


def strings_to_intervals(seqs: Sequence[str], chrom: str = 'custom'):
  """Wrap raw sequences as interval rows on a synthetic contig —
  enough structure for the plotting/eval helpers that take interval
  frames."""
  import pandas as pd
  starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])[:-1]])
  return pd.DataFrame({
      'chrom': chrom,
      'start': starts.astype(np.int64),
      'end': (starts + np.array([len(s) for s in seqs])).astype(
          np.int64),
  })
