"""Legacy text-MDLM data layer (tokenizers + datasets).

Rebuild of the reference's original Sahoo-et-al pipeline
(reference dataloader.py: get_dataset :303, get_tokenizer :488 —
openwebtext/lm1b/text8 with HF tokenizers). This container has zero
egress, so:

  * text8-style char-level tokenization is built in (no downloads)
  * HF tokenizers/datasets are used when cached locally, else a clear
    error points at the offline constraint
  * a deterministic synthetic corpus keeps the text pipeline testable

The Diffusion core is vocab-agnostic (config.alphabet_size); text runs
set ``alphabet_size`` to the tokenizer vocab and reuse the same MDLM
losses/samplers, exactly as the reference's diffusion.py twin does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from svdd.data.gosai import FaultTolerantIterator


class CharTokenizer:
  """text8-style char-level tokenizer (dataloader.py text8 path)."""

  def __init__(self, alphabet: str = 'abcdefghijklmnopqrstuvwxyz '):
    self.alphabet = alphabet
    self.vocab = {c: i for i, c in enumerate(alphabet)}
    self.inv = {i: c for c, i in self.vocab.items()}

  @property
  def vocab_size(self) -> int:
    return len(self.vocab)

  def encode(self, text: str) -> np.ndarray:
    return np.array([self.vocab[c] for c in text if c in self.vocab],
                    np.int32)

  def decode(self, tokens) -> str:
    return ''.join(self.inv.get(int(t), '?') for t in tokens)

  def batch_decode(self, batch) -> List[str]:
    return [self.decode(row) for row in np.atleast_2d(batch)]


def get_tokenizer(name: str = 'text8'):
  """(dataloader.py get_tokenizer:488). 'text8' is offline-native; HF
  names require a local cache."""
  if name == 'text8':
    return CharTokenizer()
  try:
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(name, local_files_only=True)
  except Exception as e:
    raise RuntimeError(
        f'tokenizer {name!r} needs a local HF cache; this container '
        f'has no network egress (reference dataloader.py:488)') from e


class TextDataset:
  """Fixed-length token chunks from a raw text file (text8 layout) or
  a deterministic synthetic corpus."""

  def __init__(self, split: str = 'train', length: int = 256,
               path: Optional[str] = None,
               tokenizer: Optional[CharTokenizer] = None,
               synthetic_chars: int = 2 ** 18):
    self.tokenizer = tokenizer or CharTokenizer()
    self.length = length
    if path and os.path.exists(path):
      with open(path) as f:
        text = f.read()
    else:
      # stable across processes (python str hash is salted per
      # interpreter — see data/gosai._synthetic_split)
      import zlib
      rng = np.random.default_rng(
          zlib.crc32(f'text:{split}'.encode()) % (2 ** 31))
      # markov-ish synthetic text: repeated word pool
      words = ['the', 'of', 'and', 'to', 'in', 'a', 'is', 'that',
               'for', 'it', 'zero', 'one', 'two', 'nine', 'war',
               'city', 'state', 'world', 'time', 'people']
      text = ' '.join(rng.choice(words, synthetic_chars // 5))
    tokens = self.tokenizer.encode(text)
    n_chunks = len(tokens) // length
    self.seqs = tokens[:n_chunks * length].reshape(n_chunks, length)
    self.clss = np.zeros((n_chunks, 1), np.float32)

  def __len__(self):
    return len(self.seqs)

  def __getitem__(self, idx) -> Dict[str, np.ndarray]:
    return {'seqs': self.seqs[idx],
            'attention_mask': np.ones(self.length, np.float32)}


def get_text_dataloaders(config, *, path: Optional[str] = None,
                         num_shards: int = 1, shard_index: int = 0):
  """(dataloader.py get_dataset:303 equivalent)."""
  tok = get_tokenizer('text8')
  per_shard = config.loader.global_batch_size // num_shards

  def make(split, bs, shuffle):
    ds = TextDataset(split, length=config.model.length, path=path,
                     tokenizer=tok)
    return FaultTolerantIterator(ds, bs, shuffle=shuffle,
                                 seed=config.seed,
                                 num_shards=num_shards,
                                 shard_index=shard_index)

  return (make('train', per_shard, True),
          make('val', per_shard, False), tok)


# ---------------------------------------------------------------------------
# HF text pipeline: detokenizers + wrap/group/pack (dataloader.py:24-105,
# 277-485). The packing logic is pure code and fully portable; the HF
# dataset fetch itself is gated on a local cache (zero egress here).
# ---------------------------------------------------------------------------

import re


def _apply_rules(s: str, rules) -> str:
  for pat, rep, is_re in rules:
    s = re.sub(pat, rep, s) if is_re else s.replace(pat, rep)
  return s


def wt_detokenizer(s: str) -> str:
  """WikiText detokenizer (dataloader.py:24-54)."""
  return _apply_rules(s, [
      ("s '", "s'", False),
      (r"/' [0-9]/", r"/'[0-9]/", True),
      (' @-@ ', '-', False), (' @,@ ', ',', False),
      (' @.@ ', '.', False),
      (' : ', ': ', False), (' ; ', '; ', False),
      (' . ', '. ', False), (' ! ', '! ', False),
      (' ? ', '? ', False), (' , ', ', ', False),
      (r'\(\s*([^\)]*?)\s*\)', r'(\1)', True),
      (r'\[\s*([^\]]*?)\s*\]', r'[\1]', True),
      (r'{\s*([^}]*?)\s*}', r'{\1}', True),
      (r'\"\s*([^\"]*?)\s*\"', r'"\1"', True),
      (r"'\s*([^']*?)\s*'", r"'\1'", True),
      ('= = = =', '====', False), ('= = =', '===', False),
      ('= =', '==', False),
      (' ' + chr(176) + ' ', chr(176), False),
      (' \n', '\n', False), ('\n ', '\n', False),
      (' N ', ' 1 ', False), (" 's", "'s", False),
  ])


def ptb_detokenizer(s: str) -> str:
  """Penn-Treebank detokenizer (dataloader.py:57-68)."""
  s = _apply_rules(s, [
      (" 's", "'s", False), ("s ' ", "s' ", False),
      (" n't", "n't", False), (' \n ', '\n', False),
      ('\\/', '/', False),
  ])
  for _ in range(10):
    s = s.replace(' N ', ' 1 ')
  return _apply_rules(s, [
      ('$ 1', '$1', False), ('# 1', '#1', False),
      ('<unk>', '?', False),
  ])


def lm1b_detokenizer(s: str) -> str:
  """One-Billion-Word detokenizer (dataloader.py:71-91)."""
  return _apply_rules(s, [
      ('http : / / ', 'http://', False),
      ('https : / / ', 'https://', False),
      (r" \'(\w+)", r"'\1", True),
      (r' (\w+) \. ', r' \1. ', True),
      (r' (\w+) \.$', r' \1.', True),
      (' ? ', '? ', False), (r' \?$', '?', True),
      (' ! ', '! ', False), (r' \!$', '!', True),
      (' , ', ', ', False), (' : ', ': ', False),
      (' ; ', '; ', False), (' / ', '/', False),
      (r'\" ([^\"]+) \"', r'"\1"', True),
      (r"\' ([^\']+) \'", r"'\1'", True),
      (r'\( ([^\(\)]+) \)', r'(\1)', True),
      (r'\[ ([^\[\]]+) \]', r'[\1]', True),
      ('$ ', '$', False), ('£ ', '£', False),
  ])


def lambada_detokenizer(s: str) -> str:
  return '\n' + s.replace('“', '"').replace('”', '"').strip()


def scientific_papers_detokenizer(s: str) -> str:
  return lm1b_detokenizer(wt_detokenizer(s))


DETOKENIZERS = {
    'wikitext103': wt_detokenizer, 'wikitext2': wt_detokenizer,
    'ptb': ptb_detokenizer, 'lm1b': lm1b_detokenizer,
    'lambada': lambada_detokenizer,
    'scientific_papers_arxiv': scientific_papers_detokenizer,
    'scientific_papers_pubmed': scientific_papers_detokenizer,
}


def group_and_wrap(token_lists, block_size: int, bos: int, eos: int):
  """Concatenate tokenized documents and repack into fixed blocks
  [BOS] tok... [EOS] of exactly ``block_size`` (_group_texts,
  dataloader.py:277-301: each doc already carries a trailing EOS; the
  tail remainder shorter than block_size-2 is dropped).

  Returns dict with 'input_ids' (N, block_size) int32 and
  'attention_mask' (N, block_size) float32 of ones."""
  flat: List[int] = []
  for toks in token_lists:
    flat.extend(toks)
  inner = block_size - 2
  n_blocks = len(flat) // inner
  ids = np.empty((n_blocks, block_size), np.int32)
  for i in range(n_blocks):
    ids[i, 0] = bos
    ids[i, 1:-1] = flat[i * inner:(i + 1) * inner]
    ids[i, -1] = eos
  return {'input_ids': ids,
          'attention_mask': np.ones((n_blocks, block_size), np.float32)}


def tokenize_texts(texts, tokenizer, *, wrap: bool, block_size: int,
                   detokenizer=None):
  """Reference preprocess_and_tokenize + grouping
  (dataloader.py:408-485) over raw document strings.

  wrap=True: encode each doc (no special tokens) + trailing EOS, then
  pack into [BOS]...[EOS] blocks. wrap=False: pad/truncate each doc to
  block_size with special tokens and a real attention mask."""
  if detokenizer is not None:
    texts = [detokenizer(t) for t in texts]
  eos = tokenizer.encode(tokenizer.eos_token)[0]
  bos = tokenizer.encode(tokenizer.bos_token)[0]
  if wrap:
    enc = tokenizer(list(texts), add_special_tokens=False,
                    return_attention_mask=False)
    token_lists = [t + [eos] for t in enc['input_ids']]
    return group_and_wrap(token_lists, block_size, bos, eos)
  tokenizer.padding_side = 'right'
  tokenizer.truncation_side = 'right'
  enc = tokenizer(list(texts), max_length=block_size,
                  padding='max_length', truncation=True,
                  add_special_tokens=True, return_attention_mask=True)
  return {'input_ids': np.asarray(enc['input_ids'], np.int32),
          'attention_mask': np.asarray(enc['attention_mask'],
                                       np.float32)}


def prepare_hf_tokenizer(tokenizer):
  """The reference's BOS/EOS/pad normalization (get_tokenizer,
  dataloader.py:488-520): GPT2 gets a Bert-style post-processor adding
  BOS/EOS; BOS falls back to CLS, EOS to SEP; a [PAD] token is added
  when missing."""
  import transformers
  if isinstance(tokenizer, (transformers.GPT2TokenizerFast,
                            transformers.GPT2Tokenizer)):
    import tokenizers as tklib
    tokenizer._tokenizer.post_processor = \
        tklib.processors.BertProcessing(
            (tokenizer.bos_token, tokenizer.bos_token_id),
            (tokenizer.eos_token, tokenizer.eos_token_id))
  if tokenizer.bos_token is None:
    if tokenizer.cls_token is None:
      raise AttributeError('tokenizer needs bos_token or cls_token')
    tokenizer.bos_token = tokenizer.cls_token
  if tokenizer.eos_token is None:
    if tokenizer.sep_token is None:
      raise AttributeError('tokenizer needs eos_token or sep_token')
    tokenizer.eos_token = tokenizer.sep_token
  if tokenizer.pad_token is None:
    tokenizer.add_special_tokens({'pad_token': '[PAD]'})
  return tokenizer


# HF dataset name -> (load args, text field) mirroring
# dataloader.py:320-379
HF_DATASETS = {
    'wikitext103': (('wikitext',), {'name': 'wikitext-103-raw-v1'},
                    'text'),
    'wikitext2': (('wikitext',), {'name': 'wikitext-2-raw-v1'},
                  'text'),
    'ptb': (('ptb_text_only',), {}, 'sentence'),
    'lm1b': (('lm1b',), {}, 'text'),
    'ag_news': (('ag_news',), {}, 'text'),
    'openwebtext-train': (('openwebtext',),
                          {'split': 'train[:-100000]'}, 'text'),
    'openwebtext-valid': (('openwebtext',),
                          {'split': 'train[-100000:]'}, 'text'),
    'scientific_papers_arxiv': (('scientific_papers', 'arxiv'),
                                {'trust_remote_code': True}, 'article'),
    'scientific_papers_pubmed': (('scientific_papers', 'pubmed'),
                                 {'trust_remote_code': True},
                                 'article'),
}


def get_hf_text_dataset(dataset_name: str, tokenizer, *,
                        wrap: bool = True, mode: str = 'train',
                        cache_dir: Optional[str] = None,
                        block_size: int = 1024,
                        max_docs: Optional[int] = None):
  """Reference get_dataset (dataloader.py:303-485) over a LOCAL HF
  datasets cache (this container has zero egress — point cache_dir /
  HF_DATASETS_CACHE at pre-downloaded data). Returns dict of numpy
  'input_ids'/'attention_mask'."""
  if dataset_name not in HF_DATASETS:
    raise KeyError(f'unknown dataset {dataset_name!r}; known: '
                   f'{sorted(HF_DATASETS)}')
  args, kwargs, field = HF_DATASETS[dataset_name]
  try:
    import datasets
    ds = datasets.load_dataset(
        *args, cache_dir=cache_dir, download_mode='reuse_cache_if_exists',
        **kwargs)
  except Exception as e:
    raise RuntimeError(
        f'HF dataset {dataset_name!r} needs a local datasets cache; '
        'this container has no network egress '
        '(reference dataloader.py:303)') from e
  if 'split' not in kwargs:
    ds = ds[mode]
  if max_docs is not None:
    # select BEFORE decoding the text column — ds[field] would
    # materialize every document first (openwebtext: ~8M docs)
    ds = ds.select(range(min(max_docs, len(ds))))
  texts = ds[field]
  detok = DETOKENIZERS.get(dataset_name)
  return tokenize_texts(texts, tokenizer, wrap=wrap,
                        block_size=block_size, detokenizer=detok)
