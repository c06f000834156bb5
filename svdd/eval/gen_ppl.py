"""Generative perplexity under an external AR language model.

Rebuild of the reference's ``compute_generative_perplexity`` /
``eval_retokenize`` (diffusion_gosai.py:633-737, diffusion.py twin):
generated text is re-tokenized with the eval model's tokenizer, run
through a pretrained causal LM (e.g. GPT-2) in chunks of its context
size, and the token NLLs aggregate into one perplexity with the
reference's masking semantics (count non-EOS tokens plus the first EOS,
diffusion_gosai.py:728-735).

The eval model is an external torch/HF artifact, not part of the JAX
compute path, so it runs under torch (CPU or GPU). In offline
environments without a HuggingFace cache, pass ``eval_model`` /
``tokenizer`` objects directly (the tests inject a tiny random GPT-2);
loading by name raises a clear error otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class PerplexityAggregate:
  """exp(sum nll / count) over masked token NLLs (the reference's
  torchmetrics Perplexity usage, diffusion_gosai.py:139, 735)."""
  total_nll: float = 0.0
  total_count: float = 0.0

  def update(self, nlls, mask) -> None:
    import numpy as np
    nlls = np.asarray(nlls, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    self.total_nll += float((nlls * mask).sum())
    self.total_count += float(mask.sum())

  def compute(self) -> float:
    import math
    if self.total_count == 0:
      return float('nan')
    return math.exp(self.total_nll / self.total_count)


def load_eval_model(name_or_path: str):
  """AutoModelForCausalLM + tokenizer by name (requires a local HF
  cache — this environment has no egress; see module docstring)."""
  try:
    import transformers
    # local_files_only first: instant cache hit, fast offline failure
    # (no 30 s of connection retries in egress-less environments)
    for local_only in (True, False):
      try:
        tokenizer = transformers.AutoTokenizer.from_pretrained(
            name_or_path, local_files_only=local_only)
        model = transformers.AutoModelForCausalLM.from_pretrained(
            name_or_path, local_files_only=local_only).eval()
        return model, tokenizer
      except Exception:                           # noqa: BLE001
        if not local_only:
          raise
    raise RuntimeError('unreachable')
  except Exception as exc:                        # noqa: BLE001
    raise RuntimeError(
        f'could not load eval model {name_or_path!r}; in offline '
        'environments pass eval_model/tokenizer objects directly '
        f'({exc})') from exc


def retokenize(tokenizer, text_samples: Sequence[str],
               max_length: int):
  """eval_retokenize (diffusion_gosai.py:633-675): pad+truncate with the
  eval tokenizer; context 4096 for llama2-family, 1024 otherwise."""
  os.environ['TOKENIZERS_PARALLELISM'] = 'false'
  name = getattr(tokenizer, 'name_or_path', '') or ''
  eval_context_size = 4096 if 'llama2' in name else 1024
  batch = tokenizer(list(text_samples), return_tensors='pt',
                    return_token_type_ids=False,
                    return_attention_mask=True, truncation=True,
                    padding=True, max_length=max_length)
  return batch['input_ids'], batch['attention_mask'], eval_context_size


def ar_fallback_scorer(cfg, checkpoint_path: Optional[str] = None):
  """Offline gen-ppl fallback: score with the repo's OWN AR backbone
  (models/autoregressive.ARModel — the reference's
  parameterization='ar' LM, diffusion_gosai.py:1674-1768) instead of
  an external HF model, so the metric stays runnable in environments
  with no HuggingFace cache. Returns a ``log_prob_fn(tokens) ->
  (B, L, V) log-probs`` over the task vocab.

  Pass ``checkpoint_path`` (a pytree saved by cli.main_gosai AR
  pretraining) for meaningful numbers; without one the net is randomly
  initialized (still exercises the full path; the caller warns)."""
  import jax
  import jax.numpy as jnp
  from svdd.models.autoregressive import ARModel

  model = ARModel(config=cfg, vocab_size=cfg.vocab_size)
  variables = jax.jit(model.init)(
      jax.random.key(0), jnp.zeros((1, cfg.model.length), jnp.int32),
      jnp.zeros((1,)))
  if checkpoint_path:
    from svdd.checkpoint import load_pytree
    variables = load_pytree(checkpoint_path, variables)
  # variables ride as jit ARGUMENTS (never closure constants)
  apply = jax.jit(lambda v, toks: model.apply(
      v, toks, jnp.zeros((toks.shape[0],))))
  return lambda toks: apply(variables, jnp.asarray(toks))


def compute_generative_perplexity_local(
    token_samples,
    log_prob_fn,
    eos_token_id: Optional[int] = None,
    batch_size: int = 64,
    metric: Optional[PerplexityAggregate] = None,
) -> float:
  """Generative perplexity under a LOCAL JAX causal LM returning
  (B, L, V) log-probs (e.g. ar_fallback_scorer). Same next-token NLL
  aggregation and EOS-mask semantics as the HF path
  (diffusion_gosai.py:728-735); ``eos_token_id=None`` counts every
  position (DNA/RNA vocabs have no EOS)."""
  import numpy as np
  tokens = np.asarray(token_samples)
  metric = metric if metric is not None else PerplexityAggregate()
  for s in range(0, tokens.shape[0], batch_size):
    chunk = tokens[s:s + batch_size]
    logp = np.asarray(log_prob_fn(chunk), dtype=np.float64)
    nll = -np.take_along_axis(
        logp[:, :-1], chunk[:, 1:, None], axis=-1)[..., 0]
    if eos_token_id is None:
      mask = np.ones_like(nll)
    else:
      first_eos = np.cumsum(chunk == eos_token_id, axis=-1) == 1
      token_mask = chunk != eos_token_id
      mask = (first_eos | token_mask)[:, 1:]
    metric.update(nll, mask)
  return metric.compute()


def compute_generative_perplexity(
    text_samples: Optional[List[str]] = None,
    *,
    eval_model=None,
    tokenizer=None,
    eval_model_name_or_path: str = 'gpt2',
    token_samples=None,
    max_length: int = 1024,
    batch_size: int = 8,
    metric: Optional[PerplexityAggregate] = None,
) -> float:
  """Perplexity of generated text under an external causal LM
  (compute_generative_perplexity, diffusion_gosai.py:678-737).

  Either ``text_samples`` (retokenized by ``tokenizer``) or
  pre-tokenized ``token_samples`` (the retokenize=False branch, whole
  tensor attended). Returns the aggregated perplexity; pass ``metric``
  to accumulate across calls.
  """
  import torch
  import torch.nn.functional as F

  if eval_model is None or tokenizer is None:
    eval_model, tokenizer = load_eval_model(eval_model_name_or_path)
  eval_model = eval_model.eval()

  if token_samples is not None:
    samples = torch.as_tensor(token_samples)
    attn_mask = torch.ones_like(samples)
    eval_context_size = samples.shape[-1]
  else:
    samples, attn_mask, eval_context_size = retokenize(
        tokenizer, text_samples, max_length=max_length)

  metric = metric if metric is not None else PerplexityAggregate()
  eos = tokenizer.eos_token_id
  batch_size = min(batch_size, samples.shape[0])
  # the reference silently drops the tail remainder
  # (diffusion_gosai.py:711-712); cover it instead — the metric is
  # presented as covering all samples (ADVICE r1)
  starts = range(0, samples.shape[0], batch_size)
  with torch.no_grad():
    for s in starts:
      rows = slice(s, min(s + batch_size, samples.shape[0]))
      for chunk, mask_chunk in zip(
          torch.split(samples[rows], eval_context_size, dim=-1),
          torch.split(attn_mask[rows], eval_context_size, dim=-1)):
        logits = eval_model(chunk, attention_mask=mask_chunk)[0]
        nlls = F.cross_entropy(logits[:, :-1].transpose(-1, -2),
                               chunk[:, 1:], reduction='none')
        # count every non-EOS token plus the first EOS (:728-735)
        first_eos = (chunk == eos).cumsum(-1) == 1
        token_mask = chunk != eos
        metric.update(nlls.numpy(),
                      (first_eos[:, 1:] | token_mask[:, 1:]).numpy())
  return metric.compute()
