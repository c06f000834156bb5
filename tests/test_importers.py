"""Numerical parity: reference torch architectures vs svdd flax
models, weights carried by the importers.

This is the golden-value strategy SURVEY.md §4 calls for: a torch
mirror of the reference's CNNModel (tests/torch_mirrors.py, with the
reference's module layout and checkpoint keys) runs under torch-CPU
with random weights; the importer maps its state dict into our flax
CNN; outputs must agree to float tolerance. This pins every
layout/order/activation decision in svdd.models.cnn to the reference
architecture.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')


def _load_reference_dnaconv():
  import torch_mirrors
  return torch_mirrors


def test_cnn_parity_with_reference():
  dnaconv = _load_reference_dnaconv()
  args = types.SimpleNamespace(
      clean_data=False, hidden_dim=32, num_cnn_stacks=1, dropout=0.0,
      cls_free_guidance=False)
  torch.manual_seed(0)
  tmodel = dnaconv.CNNModel(args, alphabet_size=5, num_cls=3)
  tmodel.eval()

  B, L = 3, 24
  rng = np.random.default_rng(0)
  seq = rng.integers(0, 5, size=(B, L))
  sigma = np.zeros(B, np.float32)
  with torch.no_grad():
    t_out = tmodel(torch.tensor(seq), torch.tensor(sigma)).numpy()

  from svdd.config import tiny_test_config
  from svdd.models.cnn import CNNModel
  from svdd.importers.cnn import import_cnn_params
  import jax.numpy as jnp

  cfg = tiny_test_config('rna')
  cfg.model.hidden_dim = 32
  cfg.model.num_cnn_stacks = 1
  cfg.model.length = L
  jmodel = CNNModel(config=cfg, alphabet_size=5, num_cls=3)
  sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
  variables = import_cnn_params(sd, num_layers=5)
  j_out = np.asarray(
      jmodel.apply(variables, jnp.asarray(seq), jnp.asarray(sigma)))

  np.testing.assert_allclose(j_out, t_out, atol=2e-4)


def test_cnn_parity_forward2_onehot():
  """forward2 (one-hot input) parity — the DPS gradient path."""
  dnaconv = _load_reference_dnaconv()
  args = types.SimpleNamespace(
      clean_data=False, hidden_dim=32, num_cnn_stacks=1, dropout=0.0,
      cls_free_guidance=False)
  torch.manual_seed(1)
  tmodel = dnaconv.CNNModel(args, alphabet_size=5, num_cls=3)
  tmodel.eval()
  B, L = 2, 16
  rng = np.random.default_rng(1)
  onehot = rng.random((B, L, 5)).astype(np.float32)
  sigma = np.zeros(B, np.float32)
  with torch.no_grad():
    t_out = tmodel.forward2(torch.tensor(onehot),
                            torch.tensor(sigma)).numpy()

  from svdd.config import tiny_test_config
  from svdd.models.cnn import CNNModel
  from svdd.importers.cnn import import_cnn_params
  import jax.numpy as jnp

  cfg = tiny_test_config('rna')
  cfg.model.hidden_dim = 32
  cfg.model.num_cnn_stacks = 1
  cfg.model.length = L
  jmodel = CNNModel(config=cfg, alphabet_size=5, num_cls=3)
  sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
  variables = import_cnn_params(sd, num_layers=5)
  j_out = np.asarray(jmodel.apply(
      variables, jnp.zeros((B, L), jnp.int32), jnp.asarray(sigma),
      x_onehot=jnp.asarray(onehot)))
  np.testing.assert_allclose(j_out, t_out, atol=2e-4)


def test_convgru_value_model_parity():
  """Full RNA value net: torch mirror (reference state-dict layout,
  Enformer.py:31-49) -> import_convgru_value_model -> flax
  ConvGRUValueModel; outputs must match in eval mode."""
  import jax.numpy as jnp
  import torch_mirrors as tm
  from svdd.importers.convgru import import_convgru_value_model
  from svdd.models.convgru import ConvGRUValueModel

  torch.manual_seed(0)
  mirror = tm.make_rna_value_mirror()
  tm.randomize_state_dict(mirror, seed=1)
  mirror.eval()

  B, L = 3, 50
  rng = np.random.default_rng(2)
  onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, L))]
  with torch.no_grad():
    t_out = mirror(torch.tensor(onehot)).squeeze(-1).squeeze(-1).numpy()

  sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
  variables = import_convgru_value_model(sd, n_conv=6)
  jmodel = ConvGRUValueModel()
  j_out = np.asarray(jmodel.apply(variables, jnp.asarray(onehot)))
  np.testing.assert_allclose(j_out, t_out, atol=5e-5, rtol=1e-4)


def test_enformer_value_model_parity():
  """Full DNA value net: torch mirror (EnformerTrunk + ConvHead,
  decode.py:78-80 shapes scaled down) -> import_enformer_value_model ->
  flax EnformerValueModel with scan-stacked transformer blocks."""
  import jax.numpy as jnp
  import torch_mirrors as tm
  from svdd.importers.enformer import import_enformer_value_model
  from svdd.models.enformer import EnformerValueModel

  torch.manual_seed(3)
  n_conv, channels, n_tr, heads, key_len = 3, 384, 2, 2, 8
  mirror = tm.make_dna_value_mirror(
      n_conv=n_conv, channels=channels, n_transformers=n_tr,
      n_heads=heads, key_len=key_len)
  tm.randomize_state_dict(mirror, seed=4)
  mirror.eval()

  B, L = 2, 40
  rng = np.random.default_rng(5)
  onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, L))]
  with torch.no_grad():
    t_out = mirror(torch.tensor(onehot)).squeeze(-1).squeeze(-1).numpy()

  sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
  variables = import_enformer_value_model(sd, n_conv=n_conv,
                                          n_transformers=n_tr)
  jmodel = EnformerValueModel(n_tasks=1, n_conv=n_conv,
                              channels=channels, n_transformers=n_tr,
                              n_heads=heads, key_len=key_len)
  j_out = np.asarray(jmodel.apply(variables, jnp.asarray(onehot)))
  np.testing.assert_allclose(j_out, t_out, atol=1e-4, rtol=1e-4)


def test_timed_enformer_value_model_parity():
  """Timed variant: the 128-step time-embedding table must survive the
  import (TimedEnformerTrunk, Enformer.py:1202-1268)."""
  import jax.numpy as jnp
  import torch_mirrors as tm
  from svdd.importers.enformer import import_enformer_value_model
  from svdd.models.enformer import EnformerValueModel

  torch.manual_seed(6)
  n_conv, channels, n_tr, heads, key_len = 3, 384, 1, 2, 8
  mirror = tm.make_dna_value_mirror(
      n_conv=n_conv, channels=channels, n_transformers=n_tr,
      n_heads=heads, key_len=key_len, timed=True)
  tm.randomize_state_dict(mirror, seed=7)
  mirror.eval()

  B, L = 2, 32
  rng = np.random.default_rng(8)
  onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, L))]
  t_idx = np.full((B, L), 17, np.int64)
  with torch.no_grad():
    t_out = mirror(torch.tensor(onehot),
                   torch.tensor(t_idx)).squeeze(-1).squeeze(-1).numpy()

  sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
  variables = import_enformer_value_model(
      sd, n_conv=n_conv, n_transformers=n_tr, timed=True)
  jmodel = EnformerValueModel(n_tasks=1, n_conv=n_conv,
                              channels=channels, n_transformers=n_tr,
                              n_heads=heads, key_len=key_len, timed=True)
  j_out = np.asarray(jmodel.apply(variables, jnp.asarray(onehot),
                                  time_indices=jnp.asarray(t_idx)))
  np.testing.assert_allclose(j_out, t_out, atol=1e-4, rtol=1e-4)


def test_dit_parity_with_mirror():
  """DiT backbone: torch mirror (reference state-dict layout,
  models/dit.py:324-370, plain-attention core) -> import_dit_params ->
  flax DIT in fp32."""
  import jax.numpy as jnp
  import torch_mirrors as tm
  from svdd.config import tiny_test_config
  from svdd.importers.dit import import_dit_params
  from svdd.models.dit import DIT

  torch.manual_seed(9)
  hidden, cond, heads, blocks, vocab = 32, 24, 2, 2, 5
  mirror = tm.DIT(hidden_size=hidden, cond_dim=cond, n_heads=heads,
                  n_blocks=blocks, vocab_size=vocab, dropout=0.0)
  # zero-init adaLN/output make most of the net a no-op; randomize
  sd = mirror.state_dict()
  gen = torch.Generator().manual_seed(10)
  for k, t in sd.items():
    if torch.is_floating_point(t) and ('adaLN' in k or
                                       'output_layer.linear' in k):
      sd[k] = torch.randn(t.shape, generator=gen) * 0.1
  mirror.load_state_dict(sd)
  mirror.eval()

  B, L = 2, 16
  rng = np.random.default_rng(11)
  seq = rng.integers(0, vocab, (B, L))
  sigma = np.array([0.3, 1.2], np.float32)
  with torch.no_grad():
    t_out = mirror(torch.tensor(seq), torch.tensor(sigma)).numpy()

  cfg = tiny_test_config('dna')
  cfg.model.hidden_size = hidden
  cfg.model.cond_dim = cond
  cfg.model.n_heads = heads
  cfg.model.n_blocks = blocks
  cfg.model.dropout = 0.0
  jmodel = DIT(config=cfg, vocab_size=vocab,
               compute_dtype=jnp.float32)
  variables = import_dit_params(
      {k: v.detach().numpy() for k, v in mirror.state_dict().items()},
      n_blocks=blocks)
  j_out = np.asarray(jmodel.apply(variables, jnp.asarray(seq),
                                  jnp.asarray(sigma)))
  np.testing.assert_allclose(j_out, t_out, atol=2e-5, rtol=1e-4)


def test_gru_parity_with_torch():
  """GRUCellScan + importer vs torch.nn.GRU (bidirectional, summed
  directions as GRUBlock does at Enformer.py:1620)."""
  import jax
  import jax.numpy as jnp
  from svdd.models.convgru import GRUCellScan
  from svdd.importers.convgru import import_gru_cell

  torch.manual_seed(0)
  H, IN, B, L = 6, 5, 2, 7
  tgru = torch.nn.GRU(input_size=IN, hidden_size=H, batch_first=True,
                      bidirectional=True)
  x = torch.randn(B, L, IN)
  with torch.no_grad():
    t_out, _ = tgru(x)
  t_sum = (t_out[:, :, :H] + t_out[:, :, H:]).numpy()

  sd = {k: v.detach().numpy() for k, v in tgru.state_dict().items()}
  fwd = GRUCellScan(hidden_size=H, reverse=False)
  bwd = GRUCellScan(hidden_size=H, reverse=True)
  xj = jnp.asarray(x.numpy())
  out_f = fwd.apply({'params': import_gru_cell(sd)}, xj)
  out_b = bwd.apply({'params': import_gru_cell(sd, reverse=True)}, xj)
  j_sum = np.asarray(out_f + out_b)
  np.testing.assert_allclose(j_sum, t_sum, atol=1e-5)
