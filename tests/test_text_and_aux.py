"""Legacy text pipeline, semi-AR sampling, regression data, observability."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd.config import tiny_test_config


def test_char_tokenizer_roundtrip():
  from svdd.data.text import CharTokenizer
  tok = CharTokenizer()
  ids = tok.encode('hello world')
  assert tok.decode(ids) == 'hello world'


def test_text_mdlm_pipeline():
  """Text task end-to-end: char vocab, loss step, sample."""
  from svdd.data.text import get_text_dataloaders, CharTokenizer
  from svdd.diffusion import Diffusion
  cfg = tiny_test_config('rna')
  cfg.task = 'text'
  cfg.alphabet_size = CharTokenizer().vocab_size
  cfg.model.length = 16
  train_it, _, tok = get_text_dataloaders(cfg)
  batch = next(iter(train_it))
  assert batch['seqs'].shape == (8, 16)
  model = Diffusion(cfg, rng=jax.random.key(0))
  assert model.vocab_size == tok.vocab_size + 1
  out = model.loss(model.variables, jax.random.key(1),
                   jnp.asarray(batch['seqs']))
  assert np.isfinite(float(out.loss))
  samples = model.sampler(4)(jax.random.key(2)).samples
  text = tok.batch_decode(np.asarray(samples))
  assert len(text) == 4 and all(len(t) == 16 for t in text)


def test_semi_ar_sample():
  from svdd.sampling.semi_ar import semi_ar_sample
  from svdd.diffusion import Diffusion
  cfg = tiny_test_config('rna')
  cfg.sampling.predictor = 'ddpm_cache'
  model = Diffusion(cfg, rng=jax.random.key(0))
  steps, blocks, full = semi_ar_sample(
      model, n_samples=2, stride_length=4, num_strides=2,
      key=jax.random.key(1), dt=0.1)
  L = cfg.model.length
  # (num_strides+1) blocks of stride_length + final remainder
  assert full.shape == (2, 3 * 4 + (L - 4))
  assert (full < 4).all() and (full >= 0).all()
  assert steps > 0


def test_regression_dataset_and_tokenizer(tmp_path):
  from svdd.data.regression import (DNARegressionDataset,
                                        SimpleDNATokenizer)
  tok = SimpleDNATokenizer(max_length=8)
  ids = tok.encode('ACGT')
  assert tok.decode(ids) == 'ACGT'
  vocab_path = os.path.join(tmp_path, 'vocab.json')
  tok.save_vocab(vocab_path)
  tok2 = SimpleDNATokenizer(max_length=8)
  tok2.load_vocab(vocab_path)
  assert tok2.vocab == tok.vocab

  ds = DNARegressionDataset(['ACGTACGT', 'TTTTAAAA'], [1.0, 2.0],
                            max_length=8, mode='one_hot')
  item = ds[0]
  assert item['seqs'].shape == (8, 4)
  assert item['labels'] == 1.0
  ds_tok = DNARegressionDataset(['ACGT'], [0.5], max_length=8,
                                mode='tokens')
  assert ds_tok[0]['seqs'].shape == (8,)


def test_metrics_logger_and_timer(tmp_path):
  from svdd.observability import MetricsLogger, StepTimer, nan_guard
  import json
  logger = MetricsLogger(str(tmp_path), 'test')
  logger.log({'loss': jnp.asarray(1.5)}, step=3)
  logger.finish()
  with open(logger.path) as f:
    row = json.loads(f.readline())
  assert row['loss'] == 1.5 and row['_step'] == 3

  timer = StepTimer()
  timer.start()
  x = jnp.ones((8, 8)) @ jnp.ones((8, 8))
  dt = timer.stop(x)
  assert dt > 0 and timer.summary()['steps'] == 1

  assert not bool(nan_guard({'a': jnp.ones(3)}))
  assert bool(nan_guard({'a': jnp.asarray([jnp.nan])}))


def test_group_and_wrap_blocks():
  """_group_texts parity (dataloader.py:277-301): concat docs, pack
  into [BOS] inner [EOS] blocks, drop the tail remainder."""
  import numpy as np
  from svdd.data.text import group_and_wrap

  docs = [[10, 11, 12, 99], [13, 14, 99], [15, 16, 17, 18, 99]]
  out = group_and_wrap(docs, block_size=6, bos=1, eos=2)
  ids = out['input_ids']
  flat = [t for d in docs for t in d]
  assert ids.shape == (len(flat) // 4, 6)
  for i, row in enumerate(ids):
    assert row[0] == 1 and row[-1] == 2
    assert row[1:-1].tolist() == flat[i * 4:(i + 1) * 4]
  assert out['attention_mask'].shape == ids.shape
  assert (out['attention_mask'] == 1).all()


def test_detokenizers_match_reference():
  """Pin every detokenizer byte-for-byte against the reference
  implementations (dataloader.py:24-105)."""
  import sys
  import types
  # the reference's utils.py imports lightning/timm (absent here) for
  # unrelated trainer helpers; stub them so the pure string fns load
  import importlib.machinery
  import torch

  def stub(name):
    if name in sys.modules:
      return sys.modules[name]
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    mod.__path__ = []
    sys.modules[name] = mod
    return mod

  tsched = stub('timm.scheduler')
  tsched.CosineLRScheduler = type(
      'CosineLRScheduler',
      (torch.optim.lr_scheduler._LRScheduler,), {})
  stub('timm').scheduler = tsched
  lutil = stub('lightning.pytorch.utilities')
  lutil.rank_zero_only = lambda fn: fn
  lpt = stub('lightning.pytorch')
  lpt.utilities = lutil
  stub('lightning').pytorch = lpt
  sys.path.insert(0, os.environ.get('SVDD_REFERENCE_DIR', ''))
  try:
    import dataloader as ref  # type: ignore
  except Exception:
    import pytest
    pytest.skip('reference dataloader not importable here')
  finally:
    sys.path.pop(0)
  from svdd.data import text as T

  samples = [
      "the cat 's house ( with  spaces ) and a \" quoted  bit \" , "
      "done . it was = = = = heading = = = = and s ' more \n text",
      "go to http : / / example.com , pay $ 5 now ! it is ok ?",
      "he said <unk> about the $ 1 deal and N things n't \n here",
      "a “curly” quoted line  ",
  ]
  pairs = [
      (T.wt_detokenizer, ref.wt_detokenizer),
      (T.ptb_detokenizer, ref.ptb_detokenizer),
      (T.lm1b_detokenizer, ref.lm1b_detokenizer),
      (T.lambada_detokenizer, ref.lambada_detokenizer),
      (T.scientific_papers_detokenizer,
       ref.scientific_papers_detokenizer),
  ]
  for mine, theirs in pairs:
    for s in samples:
      assert mine(s) == theirs(s), (mine.__name__, s)
