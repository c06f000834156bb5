"""ctypes bindings for the native DNA kernels (dna_kernels.cc).

Compiled lazily on first import via build.py; callers (data/gosai.py,
eval/metrics.py) fall back to numpy/python when the toolchain or the
compiled library is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np

from svdd.native.build import build

_lib = ctypes.CDLL(build())

_lib.dna_tokenize.argtypes = [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int32)]
_lib.dna_detokenize.argtypes = [
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
    ctypes.c_char_p]
_lib.kmer_count.argtypes = [
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
_lib.kmer_count.restype = ctypes.c_int64
_lib.csv_read_seq_column.argtypes = [
    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ctypes.c_int64]
_lib.csv_read_seq_column.restype = ctypes.c_int64

_ALPHA = np.frombuffer(b'ACGT', np.uint8)


def batch_tokenize(seqs: List[str]) -> np.ndarray:
  if not seqs:
    return np.zeros((0, 0), np.int32)
  length = len(seqs[0])
  blob = ''.join(seqs).encode('ascii')
  out = np.empty((len(seqs), length), np.int32)
  _lib.dna_tokenize(blob, len(seqs), length,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  return out


def batch_detokenize(tokens: np.ndarray) -> List[str]:
  tokens = np.ascontiguousarray(tokens, np.int32)
  n, length = tokens.shape
  buf = ctypes.create_string_buffer(n * length)
  _lib.dna_detokenize(
      tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      n, length, buf)
  s = buf.raw.decode('ascii')
  return [s[i * length:(i + 1) * length] for i in range(n)]


def kmer_count_table(tokens: np.ndarray, k: int) -> np.ndarray:
  """Dense 4^k count table over token arrays."""
  tokens = np.ascontiguousarray(tokens, np.int32)
  n, length = tokens.shape
  table = np.zeros(4 ** k, np.int64)
  slots = _lib.kmer_count(
      tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      n, length, k,
      table.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
  if slots < 0:
    raise ValueError(f'invalid k={k}')
  return table


def _kmer_string(code: int, k: int) -> str:
  chars = []
  for i in range(k):
    chars.append('ACGT'[(code >> (2 * (k - 1 - i))) & 3])
  return ''.join(chars)


def count_kmers(seqs: List[str], k: int = 3) -> Dict[str, int]:
  """Dict-of-strings interface matching oracle.py:75-85."""
  tokens = batch_tokenize(seqs)
  table = kmer_count_table(tokens, k)
  return {_kmer_string(i, k): int(c)
          for i, c in enumerate(table) if c > 0}


def csv_read_seq_column(path: str, column: str, seq_len: int,
                        max_rows: int = 1 << 22) -> np.ndarray:
  """Parse a CSV's sequence column straight into a token array."""
  buf = ctypes.create_string_buffer(max_rows * seq_len)
  rows = _lib.csv_read_seq_column(path.encode(), column.encode(),
                                  seq_len, buf, max_rows)
  if rows < 0:
    raise IOError(f'failed to parse {path} column {column}')
  blob = np.frombuffer(buf.raw[:rows * seq_len], np.uint8)
  out = np.empty(rows * seq_len, np.int32)
  _lib.dna_tokenize(blob.tobytes(), rows, seq_len,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  return out.reshape(rows, seq_len)


def csv_count_rows(path: str) -> int:
  """Data rows in a CSV (excluding header) — for shard planning."""
  _lib.csv_count_rows.restype = ctypes.c_int64
  return int(_lib.csv_count_rows(path.encode()))


def csv_read_gosai(path: str, seq_col: str, cls_cols: List[str],
                   seq_len: int, row_offset: int = 0,
                   max_rows: int = 1 << 22):
  """One-pass sharded Gosai read: (tokens (R, L) int32,
  clss (R, n_cls) float32) for rows [row_offset, row_offset+max_rows)."""
  n_cls = len(cls_cols)
  seq_buf = ctypes.create_string_buffer(max_rows * seq_len)
  cls_buf = np.empty(max_rows * n_cls, np.float32)
  _lib.csv_read_gosai.restype = ctypes.c_int64
  rows = _lib.csv_read_gosai(
      path.encode(), seq_col.encode(), ','.join(cls_cols).encode(),
      seq_len, row_offset, max_rows, seq_buf,
      cls_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_cls)
  if rows < 0:
    raise IOError(f'failed to parse {path} ({seq_col}, {cls_cols})')
  blob = np.frombuffer(seq_buf.raw[:rows * seq_len], np.uint8)
  toks = np.empty(rows * seq_len, np.int32)
  _lib.dna_tokenize(blob.tobytes(), rows, seq_len,
                    toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  return (toks.reshape(rows, seq_len),
          cls_buf[:rows * n_cls].reshape(rows, n_cls).copy())
