"""Validation suite, oracle training CLI, report CLI, artifacts."""

import subprocess
import sys

import jax
import numpy as np
import pytest

from svdd.config import tiny_test_config


def test_distribution_eval():
  from svdd.diffusion import Diffusion
  from svdd.data.gosai import GosaiDataset
  from svdd.eval.validation import distribution_eval
  from svdd import rewards
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  datasets = {'train': GosaiDataset('train', length=cfg.model.length),
              'val': GosaiDataset('val', length=cfg.model.length)}
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  oracle_fn = lambda onehot: np.asarray(reward(onehot))[:, None]
  out = distribution_eval(model, model.variables, datasets,
                          jax.random.key(1), oracle_fn=oracle_fn,
                          n_batches=1, batch_size=8, subset_size=64)
  assert 'kmer_pearson' in out
  assert 'ws/train_pred_hepg2' in out
  assert all(np.isfinite(v) for v in out.values())


def test_artifacts_registry():
  from svdd import artifacts
  with pytest.raises(KeyError):
    artifacts.artifact_path('nope')
  with pytest.raises(FileNotFoundError):
    artifacts.artifact_path('DNA_Diffusion')
  avail = artifacts.available_artifacts()
  assert set(avail) == set(artifacts.REGISTRY)


def test_report_cli(tmp_path):
  import numpy as np
  p = tmp_path / 'rna-MRL.npz'
  np.savez(p, decoding=np.array([1.0, 2.0, 3.0]),
           baseline=np.array([0.1, 0.2, 0.3]))
  from svdd.eval import report
  text = report.report_file(str(p))
  assert 'decoding' in text and 'reference:' in text


def test_train_oracle_learns():
  """Oracle trained on synthetic planted-motif labels should correlate
  with the labels far better than a random init."""
  from svdd.cli import train_oracle
  import argparse
  args = argparse.Namespace(
      task='rna', length=16, batch_size=32, max_iters=60,
      learning_rate=2e-3, log_every=1000, seed=0, data_dir=None,
      save_path=None, small=True)
  # run() logs val pearson; capture via the logger is awkward — call
  # the internals instead
  from svdd.data.gosai import GosaiDataset, FaultTolerantIterator
  from svdd.models.convgru import ConvGRUValueModel
  import jax.numpy as jnp
  import optax
  ds = GosaiDataset('train', length=16)
  val = GosaiDataset('val', length=16)
  module = ConvGRUValueModel(n_tasks=1)
  variables = module.init(jax.random.key(0), jnp.zeros((1, 16, 4)))
  params = variables.pop('params')
  extras = variables
  opt = optax.adamw(2e-3)
  opt_state = opt.init(params)

  @jax.jit
  def step(params, extras, opt_state, seqs, labels, key):
    def loss_fn(p):
      preds, upd = module.apply(
          {'params': p, **extras}, jax.nn.one_hot(seqs, 4),
          train=True, mutable=['batch_stats'], rngs={'dropout': key})
      return jnp.mean((preds - labels[:, 0]) ** 2), upd
    (loss, upd), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    u, opt_state = opt.update(g, opt_state, params)
    return optax.apply_updates(params, u), {**extras, **upd}, \
        opt_state, loss

  it = iter(FaultTolerantIterator(ds, 32, seed=0))
  key = jax.random.key(1)
  for i in range(60):
    b = next(it)
    key, sub = jax.random.split(key)
    params, extras, opt_state, loss = step(
        params, extras, opt_state, jnp.asarray(b['seqs']),
        jnp.asarray(b['clss']), sub)

  preds = np.asarray(module.apply(
      {'params': params, **extras},
      jax.nn.one_hot(jnp.asarray(val.seqs[:256]), 4)))
  labels = val.clss[:256, 0]
  r = np.corrcoef(preds, labels)[0, 1]
  assert r > 0.3, f'oracle failed to learn (pearson {r:.3f})'


def test_yaml_config_presets():
  import glob
  from svdd.config import Config
  paths = sorted(glob.glob('svdd/configs/*.yaml'))
  assert len(paths) >= 3
  for p in paths:
    cfg = Config.from_yaml(p)
    assert cfg.vocab_size == cfg.alphabet_size + 1
  dna = Config.from_yaml('svdd/configs/dna.yaml')
  assert dna.model.length == 200 and dna.task == 'dna'


def test_run_decode_npz_roundtrip(tmp_path):
  """decode.run_decode + save_npz: reference-compatible keys/shapes."""
  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.decode import run_decode
  from svdd import rewards
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  res = run_decode(model, reward, algo='svdd_pm', gen_batch_num=2,
                   batch_size=4, sample_M=2, seed=1)
  assert res.samples.shape == (8, cfg.model.length)
  assert res.reward_preds.shape == (8,)
  assert res.baseline_preds.shape == (8,)
  assert res.top_k.shape == (8,)          # N*M draws / M
  p = tmp_path / 'out.npz'
  res.save_npz(str(p))
  d = np.load(p)
  assert set(d.files) == {'decoding', 'baseline'}


def test_generative_perplexity_tiny_gpt2():
  """gen_ppl (diffusion_gosai.py:678-737) against an injected tiny
  random GPT-2 — validates chunking, NLL masking (non-EOS + first EOS),
  and the aggregate, without a HF download."""
  torch = pytest.importorskip('torch')
  transformers = pytest.importorskip('transformers')
  import numpy as np
  from svdd.eval.gen_ppl import (PerplexityAggregate,
                                     compute_generative_perplexity)

  cfg = transformers.GPT2Config(
      vocab_size=32, n_positions=16, n_embd=16, n_layer=1, n_head=2)
  torch.manual_seed(0)
  model = transformers.GPT2LMHeadModel(cfg).eval()

  class StubTok:
    eos_token_id = 0
    name_or_path = 'tiny'

  rng = np.random.default_rng(0)
  toks = rng.integers(1, 32, size=(4, 12))
  toks[:, -2:] = 0                         # EOS tail
  ppl = compute_generative_perplexity(
      eval_model=model, tokenizer=StubTok(), token_samples=toks,
      batch_size=2)
  assert np.isfinite(ppl) and ppl > 1.0

  # hand-check the mask/aggregate on one row
  metric = PerplexityAggregate()
  with torch.no_grad():
    logits = model(torch.tensor(toks))[0]
  nll = torch.nn.functional.cross_entropy(
      logits[:, :-1].transpose(-1, -2), torch.tensor(toks[:, 1:]),
      reduction='none').numpy()
  mask = (toks[:, 1:] != 0).astype(float)
  mask[:, -2] = 1.0                        # first EOS counted
  metric.update(nll, mask)
  assert abs(metric.compute() - ppl) < 1e-6


def test_generative_perplexity_uniform_model_exact():
  """A uniform-logits LM must give ppl == vocab_size exactly."""
  torch = pytest.importorskip('torch')
  import numpy as np
  from svdd.eval.gen_ppl import compute_generative_perplexity

  V = 16

  class UniformLM(torch.nn.Module):
    def forward(self, x, attention_mask=None):
      return (torch.zeros(x.shape + (V,)),)

    def eval(self):
      return self

  class StubTok:
    eos_token_id = V - 1
    name_or_path = 'uniform'

  toks = np.arange(1, 9, dtype=np.int64)[None].repeat(2, axis=0)
  ppl = compute_generative_perplexity(
      eval_model=UniformLM(), tokenizer=StubTok(), token_samples=toks)
  assert abs(ppl - V) < 1e-4


def test_generative_perplexity_local_uniform_exact():
  """The local-LM gen_ppl path (offline AR-backbone fallback,
  eval/gen_ppl.compute_generative_perplexity_local) must reproduce the
  HF path's semantics: uniform log-probs -> ppl == vocab_size exactly,
  with the same non-EOS + first-EOS token mask."""
  import numpy as np
  from svdd.eval.gen_ppl import compute_generative_perplexity_local

  V = 16
  uniform = lambda toks: np.full(
      np.asarray(toks).shape + (V,), -np.log(V))

  toks = np.arange(1, 9, dtype=np.int64)[None].repeat(2, axis=0)
  ppl = compute_generative_perplexity_local(toks, uniform)
  assert abs(ppl - V) < 1e-6

  # EOS masking: rows ending in EOS count non-EOS + the first EOS
  toks2 = toks.copy()
  toks2[:, -2:] = V - 1
  ppl2 = compute_generative_perplexity_local(
      toks2, uniform, eos_token_id=V - 1)
  assert abs(ppl2 - V) < 1e-6   # uniform => mask doesn't move the ppl

  # non-uniform: per-token NLLs must aggregate with the EOS mask
  rng = np.random.default_rng(0)
  raw = rng.standard_normal((2, 8, V))
  logp = raw - np.log(np.exp(raw).sum(-1, keepdims=True))
  ppl3 = compute_generative_perplexity_local(
      toks2, lambda t: logp, eos_token_id=V - 1)
  nll = -np.take_along_axis(logp[:, :-1], toks2[:, 1:, None], -1)[..., 0]
  mask = (toks2[:, 1:] != V - 1).astype(float)
  mask[:, -2] = 1.0             # first EOS counted
  want = np.exp((nll * mask).sum() / mask.sum())
  assert abs(ppl3 - want) < 1e-9


def test_ar_fallback_scorer_smoke():
  """ar_fallback_scorer builds the repo's AR backbone and yields a
  finite perplexity over token samples (the offline gen_ppl path)."""
  import numpy as np
  from svdd.config import tiny_test_config
  from svdd.eval.gen_ppl import (ar_fallback_scorer,
                                     compute_generative_perplexity_local)

  cfg = tiny_test_config('rna')
  scorer = ar_fallback_scorer(cfg)
  toks = np.random.default_rng(0).integers(
      0, 4, size=(4, cfg.model.length))
  ppl = compute_generative_perplexity_local(toks, scorer)
  assert np.isfinite(ppl) and ppl > 1.0
