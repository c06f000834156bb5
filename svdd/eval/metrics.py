"""Metrics: streaming PearsonR/R2, k-mer spectra, Wasserstein distances,
NLL/BPD/PPL aggregates, reward-quantile reports.

Rebuilds: metric.py (streaming PearsonR :4-51, R2 :54-93), oracle.py
(count_kmers :75-85, get_wasserstein_dist :158-169, emb-PCA Wasserstein
:138-156), diffusion_gosai.py NLL/BPD/Perplexity aggregates (:50-72) and
the validation-epoch distribution comparisons (:467-560), and the
quantile tables of evaluation.ipynb (cells 5-8).

Streaming metrics are pure pytree states (merge-able across shards with
a psum) instead of torch buffer modules.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray
LOG2 = math.log(2)


# ---------------------------------------------------------------------------
# Streaming PearsonR / R2  (metric.py:4-93)
# ---------------------------------------------------------------------------


class PearsonState(NamedTuple):
  count: Array
  product: Array
  true_sum: Array
  true_sumsq: Array
  pred_sum: Array
  pred_sumsq: Array

  @staticmethod
  def init(num_targets: int = 1) -> 'PearsonState':
    z = jnp.zeros((num_targets,))
    return PearsonState(z, z, z, z, z, z)

  def update(self, y_true: Array, y_pred: Array) -> 'PearsonState':
    y_true = y_true.reshape(-1, self.count.shape[0])
    y_pred = y_pred.reshape(-1, self.count.shape[0])
    return PearsonState(
        self.count + y_true.shape[0],
        self.product + jnp.sum(y_true * y_pred, 0),
        self.true_sum + jnp.sum(y_true, 0),
        self.true_sumsq + jnp.sum(y_true ** 2, 0),
        self.pred_sum + jnp.sum(y_pred, 0),
        self.pred_sumsq + jnp.sum(y_pred ** 2, 0),
    )

  def compute(self) -> Array:
    tm = self.true_sum / self.count
    pm = self.pred_sum / self.count
    cov = (self.product - tm * self.pred_sum - pm * self.true_sum
           + self.count * tm * pm)
    tv = self.true_sumsq - self.count * tm ** 2
    pv = self.pred_sumsq - self.count * pm ** 2
    return (cov / jnp.sqrt(tv * pv)).mean()


class R2State(NamedTuple):
  count: Array
  true_sum: Array
  true_sumsq: Array
  resid_sumsq: Array

  @staticmethod
  def init(num_targets: int = 1) -> 'R2State':
    z = jnp.zeros((num_targets,))
    return R2State(z, z, z, z)

  def update(self, y_true: Array, y_pred: Array) -> 'R2State':
    y_true = y_true.reshape(-1, self.count.shape[0])
    y_pred = y_pred.reshape(-1, self.count.shape[0])
    return R2State(
        self.count + y_true.shape[0],
        self.true_sum + jnp.sum(y_true, 0),
        self.true_sumsq + jnp.sum(y_true ** 2, 0),
        self.resid_sumsq + jnp.sum((y_true - y_pred) ** 2, 0),
    )

  def compute(self) -> Array:
    tm = self.true_sum / self.count
    total = self.true_sumsq - self.count * tm ** 2
    return (1.0 - self.resid_sumsq / total).mean()


# ---------------------------------------------------------------------------
# NLL / BPD / Perplexity aggregates (diffusion_gosai.py:50-72)
# ---------------------------------------------------------------------------


class NLLState(NamedTuple):
  total: Array
  weight: Array

  @staticmethod
  def init() -> 'NLLState':
    return NLLState(jnp.zeros(()), jnp.zeros(()))

  def update(self, nlls: Array, mask: Array) -> 'NLLState':
    return NLLState(self.total + (nlls * mask).sum(),
                    self.weight + mask.sum())

  def nll(self) -> Array:
    return self.total / self.weight

  def bpd(self) -> Array:
    return self.nll() / LOG2

  def ppl(self) -> Array:
    return jnp.exp(self.nll())


# ---------------------------------------------------------------------------
# Distributional comparisons (oracle.py, diffusion_gosai.py:467-560)
# ---------------------------------------------------------------------------


def wasserstein_1d(u: np.ndarray, v: np.ndarray) -> float:
  """scipy.stats.wasserstein_distance equivalent (oracle.py:158)."""
  from scipy.stats import wasserstein_distance
  return float(wasserstein_distance(np.asarray(u), np.asarray(v)))


def kmer_counts(seqs: Sequence[str], k: int = 3) -> Dict[str, int]:
  """(oracle.py:75-85) — uses the native C++ counter when available."""
  try:
    from svdd.native import bindings
    return bindings.count_kmers(list(seqs), k)
  except Exception:
    counts: Dict[str, int] = {}
    for seq in seqs:
      for i in range(len(seq) - k + 1):
        sub = seq[i:i + k]
        counts[sub] = counts.get(sub, 0) + 1
    return counts


def kmer_pearson(seqs_a: Sequence[str], seqs_b: Sequence[str],
                 k: int = 3) -> float:
  """Pearson correlation of k-mer spectra between two sequence sets
  (validation hook, diffusion_gosai.py:522-539)."""
  ca, cb = kmer_counts(seqs_a, k), kmer_counts(seqs_b, k)
  keys = sorted(set(ca) | set(cb))
  a = np.array([ca.get(x, 0) for x in keys], np.float64)
  b = np.array([cb.get(x, 0) for x in keys], np.float64)
  a = a / a.sum()
  b = b / b.sum()
  denom = a.std() * b.std()
  if denom == 0:
    return 0.0
  return float(((a - a.mean()) * (b - b.mean())).mean() / denom)


def embedding_pca_wasserstein(emb_a: np.ndarray, emb_b: np.ndarray,
                              n_components: int = 10) -> float:
  """Fréchet-style distance on PCA-projected embeddings
  (oracle.py cal_emb_pca:138-156 + get_wasserstein_dist). Projects both
  sets with PCA fit on A, sums per-component 1-D Wasserstein."""
  from sklearn.decomposition import PCA
  pca = PCA(n_components=min(n_components, emb_a.shape[1],
                             len(emb_a) - 1))
  pa = pca.fit_transform(np.asarray(emb_a))
  pb = pca.transform(np.asarray(emb_b))
  return float(sum(wasserstein_1d(pa[:, i], pb[:, i])
                   for i in range(pa.shape[1])))


def quantile_report(rewards_by_algo: Dict[str, np.ndarray],
                    quantiles=(0.5, 0.8, 0.9)) -> Dict[str, Dict[str, float]]:
  """The evaluation.ipynb quantile table (BASELINE.md rows)."""
  report = {}
  for name, r in rewards_by_algo.items():
    r = np.asarray(r).reshape(-1)
    report[name] = {f'q{int(q * 100)}': float(np.quantile(r, q))
                    for q in quantiles}
    report[name]['mean'] = float(r.mean())
    report[name]['n'] = int(r.size)
  return report
