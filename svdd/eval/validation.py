"""Sample-quality validation suite for diffusion pretraining.

Rebuild of the reference's on_validation_epoch_end hooks
(reference diffusion_gosai.py:451-565): sample N batches from the
EMA model, detokenize, then compare generated vs held-out data via

  * oracle-prediction Wasserstein distances per cell type
    (truth vs preds x hepg2/k562/sknsh x train/val/test splits,
    oracle.cal_gosai_pred + get_wasserstein_dist)
  * 3-mer Pearson correlation (diffusion_gosai.py:522-539)
  * embedding-PCA Wasserstein (oracle.cal_emb_pca:138-156)

Runs entirely from pure functions so it can be called from the Trainer
eval hook or standalone.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np

from svdd import mdlm
from svdd.data import gosai
from svdd.eval import metrics


import weakref

# compiled-sampler cache: weak-keyed on the Diffusion object (entries
# die with the model — no executable leak across models) and keyed on
# the sampling config inside (stale-config safe)
_SAMPLER_CACHE: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()


def sample_sequences(diffusion, variables, n_batches: int,
                     batch_size: int, key: jax.Array) -> np.ndarray:
  # one compiled sampler per (model, batch, sampling config); EMA
  # snapshots are jit arguments, so repeated in-training evals don't
  # recompile
  per_model = _SAMPLER_CACHE.setdefault(diffusion, {})
  cfg_key = (batch_size, diffusion.config.sampling.steps,
             diffusion.config.sampling.predictor,
             diffusion.config.noise.type)
  sampler = per_model.get(cfg_key)
  if sampler is None:
    sampler = diffusion.sampler(batch_size)
    per_model[cfg_key] = sampler
  out = []
  for i in range(n_batches):
    key, sub = jax.random.split(key)
    out.append(np.asarray(sampler(sub, variables=variables).samples))
  return np.concatenate(out)


def distribution_eval(
    diffusion,
    variables,
    datasets: Dict[str, gosai.GosaiDataset],
    key: jax.Array,
    *,
    oracle_fn=None,
    embed_fn=None,
    n_batches: int = 2,
    batch_size: int = 64,
    subset_size: int = 2048,
) -> Dict[str, float]:
  """Returns the reference's validation metric dict (flattened keys:
  'ws/<split>_truth_<task>', 'ws/<split>_pred_<task>', 'kmer_pearson',
  'emb_pca_ws')."""
  samples = sample_sequences(diffusion, variables, n_batches,
                             batch_size, key)
  gen_seqs = gosai.batch_dna_detokenize(samples)
  results: Dict[str, float] = {}

  gen_preds = None
  if oracle_fn is not None:
    gen_preds = np.asarray(
        oracle_fn(np.asarray(mdlm.transform_samples(samples))))
    if gen_preds.ndim == 1:
      gen_preds = gen_preds[:, None]

  task_names = ['hepg2', 'k562', 'sknsh']
  for split, ds in datasets.items():
    sub = np.random.default_rng(0).choice(
        len(ds), min(subset_size, len(ds)), replace=False)
    # truth labels vs generated oracle predictions
    for t, name in enumerate(task_names[:ds.clss.shape[1]]):
      if gen_preds is not None and t < gen_preds.shape[1]:
        results[f'ws/{split}_truth_{name}'] = metrics.wasserstein_1d(
            gen_preds[:, t], ds.clss[sub, t])
    if oracle_fn is not None:
      data_preds = np.asarray(oracle_fn(np.asarray(
          mdlm.transform_samples(ds.seqs[sub]))))
      if data_preds.ndim == 1:
        data_preds = data_preds[:, None]
      for t in range(min(data_preds.shape[1],
                         0 if gen_preds is None else gen_preds.shape[1])):
        name = task_names[t] if t < 3 else str(t)
        results[f'ws/{split}_pred_{name}'] = metrics.wasserstein_1d(
            gen_preds[:, t], data_preds[:, t])

  # 3-mer pearson vs train split
  if 'train' in datasets:
    train_ds = datasets['train']
    sub = np.random.default_rng(1).choice(
        len(train_ds), min(subset_size, len(train_ds)), replace=False)
    data_seqs = gosai.batch_dna_detokenize(train_ds.seqs[sub])
    results['kmer_pearson'] = metrics.kmer_pearson(gen_seqs, data_seqs)
    if embed_fn is not None:
      gen_emb = np.asarray(embed_fn(np.asarray(
          mdlm.transform_samples(samples))))
      data_emb = np.asarray(embed_fn(np.asarray(
          mdlm.transform_samples(train_ds.seqs[sub[:len(samples)]]))))
      results['emb_pca_ws'] = metrics.embedding_pca_wasserstein(
          data_emb, gen_emb)
  return results
