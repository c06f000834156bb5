"""Gosai enhancer / RNA 5'UTR datasets and DNA tokenization.

Rebuild of the reference data layer (reference dataloader_gosai.py):
CSV -> int token arrays with {'seqs','clss','attention_mask'} items
(:74-85), detokenizers (:19-32), batch-divisibility checks (:102-114).

Differences from the reference:
  * batches are host numpy arrays handed to jit as one device_put per
    step (no torch DataLoader worker pool; this host has the whole
    dataset in RAM — the Gosai CSV is ~700k rows x 200 chars).
  * tokenization runs through the native C++ kernel when built
    (svdd/native), with a numpy fallback.
  * when no CSV is present (this container has no dataset mounts), a
    deterministic synthetic dataset with planted motifs stands in so
    training/eval pipelines stay runnable end-to-end.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

DNA_ALPHABET = {'A': 0, 'C': 1, 'G': 2, 'T': 3}
INDEX_TO_DNA = np.array(['A', 'C', 'G', 'T'])
DATA_DIR = os.environ.get('SVDD_DATA_DIR', '/data/svdd')


def dna_detokenize(seq) -> str:
  """(dataloader_gosai.py:19-20)."""
  return ''.join(INDEX_TO_DNA[int(i)] for i in seq)


def batch_dna_detokenize(batch_seq: np.ndarray) -> list[str]:
  """Vectorized detokenizer (dataloader_gosai.py:22-32). Falls back to
  numpy when the native kernel is unavailable."""
  try:
    from svdd.native import bindings
    return bindings.batch_detokenize(np.asarray(batch_seq, np.int32))
  except Exception:
    chars = INDEX_TO_DNA[np.asarray(batch_seq)]
    return [''.join(row) for row in chars]


def dna_tokenize_batch(seqs: list[str]) -> np.ndarray:
  """Strings -> (N, L) int32 tokens."""
  try:
    from svdd.native import bindings
    return bindings.batch_tokenize(seqs)
  except Exception:
    lut = np.full(128, -1, np.int32)
    for ch, idx in DNA_ALPHABET.items():
      lut[ord(ch)] = idx
    arr = np.frombuffer(
        ''.join(seqs).encode('ascii'), np.uint8).astype(np.int32)
    return lut[arr].reshape(len(seqs), -1)


def _synthetic_split(split: str, n: int, length: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
  """Deterministic stand-in dataset: uniform ACGT sequences whose
  'activity' labels are planted-motif counts plus noise, giving the
  eval metrics (k-mer pearson, wasserstein) real signal."""
  # stable across processes: python's hash() of a str is SALTED per
  # interpreter (PYTHONHASHSEED), which made every process build a
  # DIFFERENT "deterministic" dataset — caught by the r5
  # resume-under-fire probe (two fresh same-seed runs diverged at
  # step 100, scripts/probe_resume_fire.py)
  import zlib
  rng = np.random.default_rng(
      zlib.crc32(f'{split}:{seed}'.encode()) % (2 ** 31))
  seqs = rng.integers(0, 4, size=(n, length), dtype=np.int64)
  # plant a GCGC-rich motif in a subset to create label structure
  motif = np.array([2, 1, 2, 1])
  hot = rng.random(n) < 0.3
  pos = rng.integers(0, length - 4, size=n)
  for i in np.nonzero(hot)[0]:
    seqs[i, pos[i]:pos[i] + 4] = motif
  windows = np.lib.stride_tricks.sliding_window_view(seqs, 4, axis=1)
  counts = (windows == motif).all(-1).sum(-1).astype(np.float32)
  clss = np.stack([
      counts + 0.1 * rng.standard_normal(n).astype(np.float32),
      0.5 * counts + 0.1 * rng.standard_normal(n).astype(np.float32),
      rng.standard_normal(n).astype(np.float32),
  ], axis=1)
  return {'seqs': seqs.astype(np.int32), 'clss': clss}


class GosaiDataset:
  """CSV-backed dataset (dataloader_gosai.py:74-85) with synthetic
  fallback. Items: seqs (L,) int32, clss (3,) float32."""

  def __init__(self, split: str = 'train', length: int = 200,
               data_dir: Optional[str] = None,
               synthetic_size: Optional[int] = None,
               row_offset: int = 0, row_limit: Optional[int] = None):
    """``row_offset``/``row_limit`` select a contiguous row shard so a
    multi-host job can load only 1/N of the file per host (the
    reference always loads everything on every rank,
    dataloader_gosai.py:76)."""
    data_dir = data_dir or DATA_DIR
    path = os.path.join(data_dir, f'gosai_{split}.csv')
    if os.path.exists(path):
      self.seqs, self.clss = self._read_csv(path, length, row_offset,
                                            row_limit)
      self.synthetic = False
    else:
      n = synthetic_size or {'train': 4096, 'val': 512,
                             'test': 512}.get(split, 512)
      d = _synthetic_split(split, n, length)
      self.seqs, self.clss = d['seqs'], d['clss']
      self.synthetic = True
    self.length = self.seqs.shape[1]

  @staticmethod
  def _read_csv(path: str, length: int, row_offset: int = 0,
                row_limit: Optional[int] = None):
    """Native one-pass reader (seq + 3 class columns, row-range
    sharded; svdd/native/dna_kernels.cc csv_read_gosai); pandas
    fallback when the shared library is unavailable."""
    max_rows = row_limit if row_limit is not None else 1 << 22
    try:
      from svdd.native import bindings
      return bindings.csv_read_gosai(
          path, 'seq', ['hepg2', 'k562', 'sknsh'], length,
          row_offset=row_offset, max_rows=max_rows)
    except Exception:                              # noqa: BLE001
      import pandas as pd
      df = pd.read_csv(path, skiprows=range(1, row_offset + 1),
                       nrows=row_limit)
      keep = df['seq'].str.len() == length
      df = df[keep]
      return (dna_tokenize_batch(df['seq'].tolist()),
              df[['hepg2', 'k562', 'sknsh']].to_numpy(np.float32))

  def __len__(self):
    return len(self.seqs)

  def __getitem__(self, idx):
    return {'seqs': self.seqs[idx], 'clss': self.clss[idx],
            'attention_mask': np.ones(self.length, np.float32)}


class FaultTolerantIterator:
  """Resumable shuffling batch iterator.

  Merges the reference's RandomFaultTolerantSampler (saved RNG state +
  counter, dataloader_gosai.py:171-215) and
  FaultTolerantDistributedSampler (epoch + counter rank-strided
  subsampling, :218-272): each process takes a strided shard; state
  (epoch, counter, seed) round-trips through ``state_dict`` /
  ``load_state_dict`` so training resumes mid-epoch exactly.
  """

  def __init__(self, dataset: GosaiDataset, batch_size: int,
               shuffle: bool = True, seed: int = 0,
               num_shards: int = 1, shard_index: int = 0,
               drop_last: bool = True):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.seed = seed
    self.num_shards = num_shards
    self.shard_index = shard_index
    self.drop_last = drop_last
    self.epoch = 0
    self.counter = 0
    self.restarted = False

  def state_dict(self) -> Dict:
    return {'epoch': self.epoch, 'counter': self.counter,
            'seed': self.seed}

  def load_state_dict(self, state: Dict) -> None:
    self.epoch = state['epoch']
    self.counter = state['counter']
    self.seed = state.get('seed', self.seed)
    self.restarted = True

  def _epoch_order(self) -> np.ndarray:
    order = np.arange(len(self.dataset))
    if self.shuffle:
      rng = np.random.default_rng(self.seed + self.epoch)
      rng.shuffle(order)
    return order[self.shard_index::self.num_shards]

  def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
    while True:
      order = self._epoch_order()
      start = self.counter if self.restarted else 0
      self.restarted = False
      self.counter = start
      limit = len(order) - (self.batch_size - 1 if self.drop_last else 0)
      while self.counter < limit:
        idx = order[self.counter:self.counter + self.batch_size]
        self.counter += len(idx)
        yield {
            'seqs': self.dataset.seqs[idx],
            'clss': self.dataset.clss[idx],
            'attention_mask': np.ones(
                (len(idx), self.dataset.length), np.float32),
        }
      self.epoch += 1
      self.counter = 0


def get_dataloaders(config, *, num_shards: int = 1, shard_index: int = 0,
                    skip_train: bool = False, skip_valid: bool = False,
                    data_dir: Optional[str] = None,
                    shard_data: bool = False):
  """(train, valid, test) iterators with global-batch divisibility
  checks (dataloader_gosai.py:102-165).

  ``shard_data=True`` splits the CSV into contiguous row ranges so each
  host reads and holds only 1/num_shards of the data (native sharded
  reader); default False keeps the reference's semantics (every rank
  holds the full dataset, iterator stride-shards the indices)."""
  if config.loader.global_batch_size % num_shards != 0:
    raise ValueError(
        f'Train batch size {config.loader.global_batch_size} not '
        f'divisible by {num_shards} shards.')
  if config.loader.eval_global_batch_size % num_shards != 0:
    raise ValueError(
        f'Eval batch size {config.loader.eval_global_batch_size} not '
        f'divisible by {num_shards} shards.')
  per_shard = config.loader.global_batch_size // num_shards
  eval_per_shard = config.loader.eval_global_batch_size // num_shards
  length = config.model.length

  def make(split, bs, shuffle):
    if shard_data and num_shards > 1:
      path = os.path.join(data_dir or DATA_DIR, f'gosai_{split}.csv')
      total = None
      if os.path.exists(path):
        try:
          from svdd.native import bindings
          total = bindings.csv_count_rows(path)
        except Exception:                          # noqa: BLE001
          total = None
      if total is not None and total > 0:
        share = total // num_shards
        ds = GosaiDataset(split, length=length, data_dir=data_dir,
                          row_offset=share * shard_index,
                          row_limit=share)
        # rows are pre-sharded; iterate the local shard unsharded
        return FaultTolerantIterator(ds, bs, shuffle=shuffle,
                                     seed=config.seed + shard_index)
    ds = GosaiDataset(split, length=length, data_dir=data_dir)
    return FaultTolerantIterator(
        ds, bs, shuffle=shuffle, seed=config.seed,
        num_shards=num_shards, shard_index=shard_index)

  train = None if skip_train else make('train', per_shard, True)
  valid = None if skip_valid else make('val', eval_per_shard, False)
  test = None if skip_valid else make('test', eval_per_shard, False)
  return train, valid, test
