"""Interpretability: ISM, gradient attributions, attention maps.

Rebuild of the reference score.py (reference score.py): ISM
(:18-113), captum-based attributions deepshap/IG/inputxgrad (:115-247),
TF-MoDISco hook (:249-390), attention-score extraction (:393-437).

Design: ISM is one batched predict over all L*3 single-base
mutants (folded into the batch dim, one forward); attributions use
jax.grad/vmap directly — no captum. DeepSHAP is approximated by
expected gradients over shuffled references (the same estimator family
captum's GradientShap uses).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray
PredictFn = Callable[[Array], Array]   # (N, L, 4) one-hot -> (N,)


def ism_predict(predict_fn: PredictFn, onehot: Array,
                batch_size: int = 512) -> np.ndarray:
  """In-silico mutagenesis (score.py ISM_predict:18-113).

  onehot: (L, 4) single sequence. Returns (L, 4) matrix of predictions
  with base b substituted at position l (reference ISM output shape).
  All 4L mutants run as batched forwards.
  """
  L = onehot.shape[0]
  eye = jnp.eye(4)
  # mutants[l, b] = onehot with row l replaced by base b
  mutants = jnp.tile(onehot[None, None], (L, 4, 1, 1))
  idx_l = jnp.arange(L)
  mutants = mutants.at[idx_l[:, None], jnp.arange(4)[None, :],
                       idx_l[:, None]].set(eye[None])
  flat = mutants.reshape(L * 4, L, 4)
  preds = []
  for i in range(0, L * 4, batch_size):
    preds.append(np.asarray(predict_fn(flat[i:i + batch_size])))
  return np.concatenate(preds).reshape(L, 4)


def input_x_gradient(predict_fn: PredictFn, onehot: Array) -> Array:
  """input*grad attribution (score.py get_attributions
  method='inputxgradient')."""
  grad = jax.grad(lambda x: predict_fn(x[None])[0])(onehot)
  return grad * onehot


def integrated_gradients(predict_fn: PredictFn, onehot: Array,
                         steps: int = 32,
                         baseline: Optional[Array] = None) -> Array:
  """IG attribution (score.py method='integratedgradients')."""
  if baseline is None:
    baseline = jnp.full_like(onehot, 0.25)
  alphas = jnp.linspace(0.0, 1.0, steps)
  path = baseline[None] + alphas[:, None, None] * (onehot
                                                   - baseline)[None]
  grads = jax.vmap(
      jax.grad(lambda x: predict_fn(x[None])[0]))(path)
  return (onehot - baseline) * grads.mean(axis=0)


def expected_gradients(predict_fn: PredictFn, onehot: Array,
                       key: jax.Array, n_refs: int = 20) -> Array:
  """GradientShap-style attribution vs dinucleotide-shuffled references
  (score.py method='deepshap' with shuffled refs :166-190)."""
  L = onehot.shape[0]
  keys = jax.random.split(key, n_refs)

  def one_ref(k):
    k1, k2 = jax.random.split(k)
    perm = jax.random.permutation(k1, L)
    ref = onehot[perm]
    alpha = jax.random.uniform(k2)
    point = ref + alpha * (onehot - ref)
    g = jax.grad(lambda x: predict_fn(x[None])[0])(point)
    return (onehot - ref) * g

  return jax.vmap(one_ref)(keys).mean(axis=0)


def get_attributions(predict_fn: PredictFn, onehot: Array,
                     method: str = 'deepshap',
                     key: Optional[jax.Array] = None,
                     **kwargs) -> np.ndarray:
  """Dispatch matching score.py get_attributions:115-247."""
  if method == 'deepshap':
    key = key if key is not None else jax.random.key(0)
    out = expected_gradients(predict_fn, onehot, key, **kwargs)
  elif method == 'integratedgradients':
    out = integrated_gradients(predict_fn, onehot, **kwargs)
  elif method == 'inputxgradient':
    out = input_x_gradient(predict_fn, onehot)
  elif method == 'ism':
    ism = ism_predict(predict_fn, onehot)
    ref = float(predict_fn(onehot[None])[0])
    out = jnp.asarray(ism - ref) * onehot
  else:
    raise NotImplementedError(method)
  return np.asarray(out)


def extract_seqlets(attributions: np.ndarray, onehots: np.ndarray,
                    window: int = 8, per_seq: int = 3,
                    min_frac: float = 0.3):
  """High-attribution windows ("seqlets"). attributions/onehots
  (N, L, 4). Returns (windows (M, window, 4) one-hot,
  attr_windows (M, window, 4), scores (M,))."""
  attributions = np.asarray(attributions, np.float64)
  onehots = np.asarray(onehots, np.float64)
  proj = (attributions * onehots).sum(-1)            # (N, L)
  n, length = proj.shape
  kern = np.ones(window)
  wins, awins, scores = [], [], []
  for i in range(n):
    sliding = np.convolve(proj[i], kern, mode='valid')  # (L-w+1,)
    cutoff = min_frac * max(sliding.max(), 1e-12)
    taken: list[int] = []
    for start in np.argsort(sliding)[::-1]:
      if len(taken) >= per_seq or sliding[start] < cutoff:
        break
      if any(abs(start - t) < window for t in taken):
        continue
      taken.append(int(start))
      wins.append(onehots[i, start:start + window])
      awins.append(attributions[i, start:start + window])
      scores.append(float(sliding[start]))
  if not wins:
    z = np.zeros((0, window, 4))
    return z, z, np.zeros((0,))
  return np.stack(wins), np.stack(awins), np.asarray(scores)


def _best_shift_similarity(pwm: np.ndarray, win: np.ndarray,
                           max_shift: int = 2):
  """Max normalized correlation of ``win`` against ``pwm`` over small
  offsets (both (w, 4)). Returns (similarity, shift)."""
  def ncc(a, b):
    a = a - a.mean()
    b = b - b.mean()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float((a * b).sum() / denom) if denom > 0 else 0.0
  best, best_s = -1.0, 0
  w = pwm.shape[0]
  for s in range(-max_shift, max_shift + 1):
    lo, hi = max(0, s), min(w, w + s)
    if hi - lo < w // 2:
      continue
    sim = ncc(pwm[lo:hi], win[lo - s:hi - s])
    if sim > best:
      best, best_s = sim, s
  return best, best_s


def cluster_seqlets(windows: np.ndarray, scores: np.ndarray,
                    sim_threshold: float = 0.6, max_shift: int = 2):
  """Greedy PWM clustering of seqlets by shifted correlation. Returns
  a list of dicts {'pwm' (w,4) frequency matrix, 'n', 'score'}."""
  clusters: list[dict] = []
  for idx in np.argsort(scores)[::-1]:
    win = windows[idx]
    placed = False
    for c in clusters:
      pwm = c['sum'] / max(c['n'], 1)
      sim, shift = _best_shift_similarity(pwm, win, max_shift)
      if sim >= sim_threshold:
        w = pwm.shape[0]
        lo, hi = max(0, shift), min(w, w + shift)
        c['sum'][lo:hi] += win[lo - shift:hi - shift]
        c['n'] += 1
        c['score'] += float(scores[idx])
        placed = True
        break
    if not placed:
      clusters.append({'sum': win.copy(), 'n': 1,
                       'score': float(scores[idx])})
  out = []
  for c in sorted(clusters, key=lambda c: -c['score']):
    pwm = c['sum'] / c['n']
    pwm = pwm / np.maximum(pwm.sum(-1, keepdims=True), 1e-9)
    out.append({'pwm': pwm, 'n': c['n'], 'score': c['score']})
  return out


def write_meme(motifs, path: str) -> None:
  """Minimal MEME-format motif file (the reference hands modisco's h5
  to a MEME db for TOMTOM, score.py:379-390)."""
  with open(path, 'w') as f:
    f.write('MEME version 4\n\nALPHABET= ACGT\n\n'
            'strands: + -\n\n'
            'Background letter frequencies\n'
            'A 0.25 C 0.25 G 0.25 T 0.25\n\n')
    for i, m in enumerate(motifs):
      pwm = m['pwm']
      f.write(f'MOTIF motif_{i}\n')
      f.write(f'letter-probability matrix: alength= 4 w= {pwm.shape[0]}'
              f' nsites= {m["n"]}\n')
      for row in pwm:
        f.write(' '.join(f'{v:.6f}' for v in row) + '\n')
      f.write('\n')


def run_modisco(attributions: np.ndarray, onehots: np.ndarray,
                out_dir: str = './modisco', window: int = 8,
                sim_threshold: float = 0.6, **kwargs):
  """Motif discovery + report (score.py run_modisco:249-390).

  Uses TF-MoDISco (modiscolite) when installed — the reference path,
  writing modisco_report.h5. This image ships without modiscolite, so
  the built-in fallback runs a lightweight discovery (seqlet
  extraction around attribution peaks + greedy shifted-PWM
  clustering) and writes motifs.meme, report.json, and per-motif logo
  PNGs to ``out_dir``. Returns the motif list (or modisco patterns).
  """
  import json
  import os
  os.makedirs(out_dir, exist_ok=True)
  try:
    import modiscolite
    pos_patterns, neg_patterns = modiscolite.tfmodisco.TFMoDISco(
        hypothetical_contribs=np.asarray(attributions).transpose(
            0, 2, 1).astype('float32'),
        one_hot=np.asarray(onehots).transpose(0, 2, 1).astype(
            'float32'), **kwargs)
    h5 = os.path.join(out_dir, 'modisco_report.h5')
    modiscolite.io.save_hdf5(h5, pos_patterns, neg_patterns,
                             window_size=20)
    return pos_patterns, neg_patterns
  except ImportError:
    pass
  wins, awins, scores = extract_seqlets(attributions, onehots,
                                        window=window)
  motifs = cluster_seqlets(wins, scores, sim_threshold=sim_threshold)
  write_meme(motifs, os.path.join(out_dir, 'motifs.meme'))
  report = [{'motif': f'motif_{i}', 'n_seqlets': m['n'],
             'score': m['score'],
             'consensus': ''.join('ACGT'[b]
                                  for b in m['pwm'].argmax(-1))}
            for i, m in enumerate(motifs)]
  with open(os.path.join(out_dir, 'report.json'), 'w') as f:
    json.dump(report, f, indent=2)
  try:
    from svdd.analysis.visualize import plot_sequence_logo
    for i, m in enumerate(motifs[:8]):
      # per-position information content: IC = sum_b p_b log2(p_b/q)
      ic = (m['pwm'] * np.log2(np.maximum(m['pwm'], 1e-9) / 0.25)).sum(
          -1, keepdims=True).clip(min=0)
      info = m['pwm'] * ic
      plot_sequence_logo(
          info, save_path=os.path.join(out_dir, f'motif_{i}.png'))
  except Exception:                                  # noqa: BLE001
    pass
  return motifs


def get_attention_scores(module, variables, onehot: Array,
                         block_idx: Optional[int] = None) -> np.ndarray:
  """Attention-map extraction (score.py get_attention_scores:393-437).

  Applies an Enformer value/trunk module with
  ``mutable=['intermediates']``; EnformerAttention sows its softmax
  weights (models/enformer.py). Returns (Layers, Heads, L', L') for a
  single input sequence (batch squeezed), or (Heads, L', L') when
  ``block_idx`` selects one transformer layer — the reference's exact
  return contract.
  """
  if onehot.ndim == 2:
    onehot = onehot[None]
  _, inter = module.apply(variables, onehot, mutable=['intermediates'])

  import re

  def natkey(s):
    return [int(t) if t.isdigit() else t
            for t in re.split(r'(\d+)', str(s))]

  maps = []
  def collect(tree):
    if isinstance(tree, dict):
      for k in sorted(tree, key=natkey):
        if k == 'attention':
          maps.extend(tree[k] if isinstance(tree[k], (tuple, list))
                      else [tree[k]])
        else:
          collect(tree[k])
  collect(inter)
  if not maps:
    raise ValueError('no attention maps sown — module has no '
                     'EnformerAttention layers')
  stacked = []
  for m in maps:
    m = np.asarray(m)
    # scan-over-layers tower sows one stacked (Layers, B, H, L, L);
    # unscanned towers sow (B, H, L, L) per block
    stacked.extend(m if m.ndim == 5 else [m])
  attn = np.stack(stacked)                     # (Layers, B, H, L, L)
  if attn.shape[1] == 1:
    attn = attn[:, 0]                          # reference squeeze(0)
  return attn[block_idx] if block_idx is not None else attn
