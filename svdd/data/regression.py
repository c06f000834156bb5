"""Legacy value-net regression datasets + simple DNA tokenizer.

Rebuild of the reference dataset.py (reference dataset.py):
per-prefix regression datasets over enhancer CSVs (DNA_reg_Dataset :14,
DNA_reg_conv_Dataset :73) and the char-level SimpleDNATokenizer with a
saved vocab JSON (:157-240).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class SimpleDNATokenizer:
  """Char-level tokenizer with special tokens and a persistable vocab
  (dataset.py:157-240)."""

  def __init__(self, max_length: int,
               special_tokens: Sequence[str] = ('<pad>', '<mask>')):
    self.max_length = max_length
    self.vocab: Dict[str, int] = {}
    for tok in special_tokens:
      self.vocab[tok] = len(self.vocab)
    for ch in 'ACGTN':
      self.vocab[ch] = len(self.vocab)
    self.inv = {v: k for k, v in self.vocab.items()}

  @property
  def pad_id(self) -> int:
    return self.vocab['<pad>']

  def encode(self, seq: str) -> np.ndarray:
    ids = [self.vocab.get(c, self.vocab['N']) for c in seq.upper()]
    ids = ids[:self.max_length]
    ids += [self.pad_id] * (self.max_length - len(ids))
    return np.asarray(ids, np.int32)

  def decode(self, ids) -> str:
    return ''.join(self.inv.get(int(i), 'N') for i in ids
                   if int(i) != self.pad_id)

  def save_vocab(self, path: str) -> None:
    with open(path, 'w') as f:
      json.dump(self.vocab, f)

  def load_vocab(self, path: str) -> None:
    with open(path) as f:
      self.vocab = json.load(f)
    self.inv = {v: k for k, v in self.vocab.items()}


class DNARegressionDataset:
  """(sequence, activity) regression items, one-hot or token encoded
  (dataset.py DNA_reg_Dataset:14-71 / DNA_reg_conv_Dataset:73-155).

  mode='tokens' yields int ids via SimpleDNATokenizer;
  mode='one_hot' yields (L, 4) float arrays (the conv variant).
  """

  def __init__(self, seqs: Sequence[str], labels: Sequence[float],
               max_length: int, mode: str = 'one_hot',
               tokenizer: Optional[SimpleDNATokenizer] = None):
    assert mode in ('tokens', 'one_hot')
    self.mode = mode
    self.max_length = max_length
    self.tokenizer = tokenizer or SimpleDNATokenizer(max_length)
    self.labels = np.asarray(labels, np.float32)
    self.token_ids = np.stack(
        [self.tokenizer.encode(s) for s in seqs])
    if mode == 'one_hot':
      from svdd.data.gosai import dna_tokenize_batch
      padded = [s[:max_length].ljust(max_length, 'N') for s in seqs]
      toks = dna_tokenize_batch(padded)
      onehot = np.zeros(toks.shape + (4,), np.float32)
      valid = (toks >= 0) & (toks < 4)
      np.put_along_axis(onehot, np.clip(toks, 0, 3)[..., None],
                        valid[..., None].astype(np.float32), axis=-1)
      self.onehots = onehot

  @classmethod
  def from_csv(cls, path: str, max_length: int, seq_col: str = 'seq',
               label_col: str = 'hepg2', **kwargs
               ) -> 'DNARegressionDataset':
    import pandas as pd
    df = pd.read_csv(path)
    return cls(df[seq_col].tolist(), df[label_col].to_numpy(),
               max_length, **kwargs)

  def __len__(self):
    return len(self.labels)

  def __getitem__(self, idx):
    if self.mode == 'tokens':
      return {'seqs': self.token_ids[idx], 'labels': self.labels[idx]}
    return {'seqs': self.onehots[idx], 'labels': self.labels[idx]}
