"""The CNN denoiser layer and the im2col conv against independent
oracles built on lax.conv_general_dilated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd.ops.cnn_layer import cnn_layer_reference
from svdd.ops.conv1d import conv1d_shifted, live_offsets


def _rand(key, shape, scale=1.0):
  return scale * jax.random.normal(jax.random.key(key), shape,
                                   jnp.float32)


def _lax_conv(x, w, dilation):
  """SAME conv1d oracle; x (N, L, Cin), w (K, Cin, Cout), f32 math."""
  k = w.shape[0]
  half = (k - 1) // 2 * dilation
  return jax.lax.conv_general_dilated(
      x.astype(jnp.float32), w.astype(jnp.float32), window_strides=(1,),
      padding=[(half, half)], rhs_dilation=(dilation,),
      dimension_numbers=('NWC', 'WIO', 'NWC'),
      precision=jax.lax.Precision.HIGHEST)


def _layer_oracle(x, br, g, b, w, cb, dilation, eps=1e-6):
  """relu(conv(LayerNorm(x + br))) + x, all in f32 via lax.conv."""
  x32 = x.astype(jnp.float32)
  h = x32 + br.astype(jnp.float32)[:, None, :]
  mu = h.mean(-1, keepdims=True)
  var = ((h - mu) ** 2).mean(-1, keepdims=True)
  h = (h - mu) / jnp.sqrt(var + eps) * g + b
  return jax.nn.relu(_lax_conv(h, w, dilation) + cb) + x32


def _layer_args(n, l, c, dtype, k=9):
  x = _rand(0, (n, l, c)).astype(dtype)
  br = _rand(1, (n, c), 0.5).astype(dtype)
  g = 1.0 + 0.1 * _rand(2, (c,))
  b = 0.1 * _rand(3, (c,))
  w = _rand(4, (k, c, c), 0.05)
  cb = 0.1 * _rand(5, (c,))
  return x, br, g, b, w, cb


# bf16 layers round the LN output, the conv operands and the sum to
# 8-bit mantissas; 3e-2 abs on O(1) activations is a few bf16 ulps
_TOL = {jnp.float32: 1e-4, jnp.bfloat16: 3e-2}


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('dilation', [1, 4, 16, 64])
def test_cnn_layer_reference_matches_lax_oracle(dilation, dtype):
  """Forward at the flagship L=200, C=128, k=9 per dilation."""
  args = _layer_args(4, 200, 128, dtype)
  got = cnn_layer_reference(*args, dilation=dilation)
  assert got.dtype == dtype
  want = _layer_oracle(*args, dilation)
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want), atol=_TOL[dtype],
                             rtol=_TOL[dtype])


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('dilation', [1, 4, 16, 64])
def test_cnn_layer_reference_grad_matches_lax_oracle(dilation, dtype):
  """Gradient wrt every input (x, time bias, LN affine, kernel, conv
  bias): the rule XLA derives for DPS / classifier guidance and the
  diffusion train step, against the oracle's f32 gradient."""
  args = _layer_args(2, 200, 128, dtype)
  ct = _rand(6, (2, 200, 128))

  def loss(fn, *a):
    return jnp.sum(fn(*a).astype(jnp.float32) * ct)

  got = jax.grad(lambda *a: loss(
      lambda *b: cnn_layer_reference(*b, dilation=dilation), *a),
      argnums=tuple(range(6)))(*args)
  f32_args = [a.astype(jnp.float32) for a in args]
  want = jax.grad(lambda *a: loss(
      lambda *b: _layer_oracle(*b, dilation), *a),
      argnums=tuple(range(6)))(*f32_args)
  for name, gv, wv in zip(('x', 'bias_row', 'ln_scale', 'ln_bias',
                           'kernel', 'conv_bias'), got, want):
    gv, wv = np.asarray(gv, np.float32), np.asarray(wv)
    if dtype == jnp.float32:
      np.testing.assert_allclose(gv, wv, atol=1e-4 * max(
          float(np.abs(wv).max()), 1.0), rtol=1e-4,
                                 err_msg=f'd{dilation} {name}')
    else:
      # bf16 keeps 8 mantissa bits at every cast of the forward (LN
      # output, conv output, sum) and the backward reuses them; the
      # rounding also flips relu masks near zero. So compare the whole
      # gradient by relative norm: 3-7% on this grid, bound 10%.
      rel = np.linalg.norm(gv - wv) / np.linalg.norm(wv)
      assert rel < 0.1, (f'd{dilation} {name}', rel)


@pytest.mark.parametrize('dilation', [16, 64])
def test_cnn_layer_reference_dead_taps_l50(dilation):
  """At the RNA length L=50 the dilation-16/64 layers have taps that
  read only padding; the dropped taps must not change the result
  (forward and input gradient)."""
  args = _layer_args(3, 50, 128, jnp.float32)
  assert len(live_offsets(9, 50, dilation)) < 9
  got = cnn_layer_reference(*args, dilation=dilation)
  want = _layer_oracle(*args, dilation)
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             atol=1e-4, rtol=1e-4)
  gx = jax.grad(lambda x: cnn_layer_reference(
      x, *args[1:], dilation=dilation).sum())(args[0])
  wx = jax.grad(lambda x: _layer_oracle(
      x, *args[1:], dilation).sum())(args[0])
  np.testing.assert_allclose(np.asarray(gx), np.asarray(wx),
                             atol=1e-3, rtol=1e-4)


def test_cnn_layer_reference_matches_module_semantics():
  """cnn_layer_reference == the historical per-op CNN layer body
  (bias add -> LayerNorm(eps 1e-6) -> dilated conv -> relu -> +x)."""
  import flax.linen as nn
  n, l, c, k, dil = 4, 30, 128, 9, 4
  x = _rand(0, (n, l, c))
  br = _rand(1, (n, c), 0.5)
  g = 1.0 + 0.1 * _rand(2, (c,))
  b = 0.1 * _rand(3, (c,))
  w = _rand(4, (k, c, c), 0.05)
  cb = 0.1 * _rand(5, (c,))
  h = x + br[:, None, :]
  ln = nn.LayerNorm(use_fast_variance=False)
  h = ln.apply({'params': {'scale': g, 'bias': b}}, h)
  want = jax.nn.relu(conv1d_shifted(h, w, cb, dil)) + x
  got = cnn_layer_reference(x, br, g, b, w, cb, dil)
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             atol=1e-5, rtol=1e-5)


def test_cnn_layer_bf16_dtype_discipline():
  """bf16 activations with f32 params must stay bf16 through the layer
  (an f32 conv-bias promotion would silently upcast the whole bf16
  denoiser), and the VJP must accept bf16 cotangents."""
  n, l, c, k, dil = 8, 20, 128, 9, 4
  x = _rand(0, (n, l, c)).astype(jnp.bfloat16)
  br = _rand(1, (n, c), 0.5).astype(jnp.bfloat16)
  g = (1.0 + 0.1 * _rand(2, (c,)))            # f32 params
  b = 0.1 * _rand(3, (c,))
  w = _rand(4, (k, c, c), 0.05)
  cb = 0.1 * _rand(5, (c,))
  out = cnn_layer_reference(x, br, g, b, w, cb, dil)
  assert out.dtype == jnp.bfloat16

  def loss(x):
    return jnp.sum(cnn_layer_reference(x, br, g, b, w, cb, dil)
                   .astype(jnp.float32))
  gx = jax.grad(loss)(x)
  assert gx.dtype == jnp.bfloat16
  assert bool(jnp.isfinite(gx.astype(jnp.float32)).all())


# (k, dilation, cin, cout): the value tower's stem (k=15) and tower
# (k=5) convs, the denoiser's k=9 dilated convs, and odd lengths
_CONV_GRID = [
    (5, 1, 128, 256, 25),
    (15, 1, 4, 128, 40),
    (9, 4, 128, 128, 30),
    (9, 64, 128, 128, 200),
    (5, 1, 256, 128, 13),
    (3, 1, 128, 128, 4),
]


@pytest.mark.parametrize('k,dil,cin,cout,l', _CONV_GRID)
def test_conv1d_shifted_matches_lax_conv(k, dil, cin, cout, l):
  x = _rand(0, (3, l, cin))
  w = _rand(1, (k, cin, cout), 0.1)
  bias = _rand(2, (cout,), 0.1)
  got = conv1d_shifted(x, w, bias, dil)
  want = _lax_conv(x, w, dil) + bias
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('k,dil,cin,cout,l', _CONV_GRID)
def test_conv1d_shifted_vjp_matches_lax_conv(k, dil, cin, cout, l):
  """dx and dW of the im2col conv (plain XLA differentiation) against
  lax.conv's VJP."""
  x = _rand(0, (2, l, cin))
  w = _rand(1, (k, cin, cout), 0.1)
  ct = _rand(3, (2, l, cout))
  _, vjp = jax.vjp(lambda a, b: conv1d_shifted(a, b, None, dil), x, w)
  _, vjp_ref = jax.vjp(lambda a, b: _lax_conv(a, b, dil), x, w)
  for got, want in zip(vjp(ct), vjp_ref(ct)):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-4)


def test_conv1d_shifted_bf16_accumulates_in_f32():
  """bf16 operands, f32 accumulation, bf16 result — within bf16
  rounding of the f32 oracle at the tower's widest stem product."""
  x = _rand(0, (2, 50, 256)).astype(jnp.bfloat16)
  w = _rand(1, (5, 256, 128), 0.05).astype(jnp.bfloat16)
  got = conv1d_shifted(x, w, None, 1)
  assert got.dtype == jnp.bfloat16
  want = _lax_conv(x, w, 1)
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want), atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
def test_conv1d_shifted_tap_sum_path_matches_im2col(monkeypatch, dtype):
  """Above the im2col byte cap the taps run as separate matmuls; both
  formulations give the same conv."""
  import svdd.ops.conv1d as conv_mod
  x = _rand(0, (2, 40, 128)).astype(dtype)
  w = _rand(1, (9, 128, 128), 0.05).astype(dtype)
  want = conv1d_shifted(x, w, None, 4)
  monkeypatch.setattr(conv_mod, 'IM2COL_MAX_BYTES', 0)
  got = conv1d_shifted(x, w, None, 4)
  assert got.dtype == dtype
  tol = _TOL[dtype]
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32),
                             atol=tol, rtol=tol)
