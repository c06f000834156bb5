"""1-D convolution as one im2col matmul.

A k-tap SAME conv1d is

    y[l] = sum_k  x[l + (k - K//2) * dilation] @ W[k]

i.e. K shifted (B*L, Cin) x (Cin, Cout) products. The shifts are static
pads/slices, stacked along channels, so the conv becomes ONE
(B*L, K_live*Cin) x (K_live*Cin, Cout) matmul that XLA hands to cuBLAS.
Param layout matches flax nn.Conv ((K, Cin, Cout) kernel, (Cout,) bias)
so checkpoints interop.
"""

from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

Array = jnp.ndarray

# above this many bytes of stacked im2col buffer the taps run as
# separate matmuls (see conv1d_shifted)
IM2COL_MAX_BYTES = 2 * 2 ** 30


def live_offsets(k_taps: int, length: int, dilation: int = 1
                 ) -> list[int]:
  """Static tap offsets with |off| < length: a tap whose offset reaches
  past the sequence reads only zero padding and is dropped."""
  half = (k_taps - 1) // 2 * dilation
  return [k * dilation - half for k in range(k_taps)
          if -length < k * dilation - half < length]


def _shift(x: Array, off: int) -> Array:
  """shifted[:, i] = x[:, i + off], zero-filled at the edge."""
  l = x.shape[1]
  if off > 0:
    return jnp.pad(x[:, off:], ((0, 0), (0, off), (0, 0)))
  if off < 0:
    return jnp.pad(x[:, :l + off], ((0, 0), (-off, 0), (0, 0)))
  return x


def conv1d_shifted(x: Array, kernel: Array, bias: Array | None = None,
                   dilation: int = 1) -> Array:
  """SAME-padded conv1d; x (B, L, Cin), kernel (K, Cin, Cout).

  Dead taps (|offset| >= L) are skipped, so the dilation-64 layers at
  L=50 do no work on pure padding. Each product accumulates in f32 and
  is cast back to the input dtype. When the stacked im2col buffer would
  pass IM2COL_MAX_BYTES, the taps run as separate matmuls summed in the
  input dtype instead, which moves more bytes but holds one shifted
  copy at a time."""
  k_taps, _, c_out = kernel.shape
  half = (k_taps - 1) // 2 * dilation
  offs = live_offsets(k_taps, x.shape[1], dilation)
  taps = [kernel[(off + half) // dilation] for off in offs]
  if not offs:
    out = jnp.zeros(x.shape[:-1] + (c_out,), x.dtype)
  elif x.size * len(offs) * x.dtype.itemsize <= IM2COL_MAX_BYTES:
    cols = jnp.concatenate([_shift(x, off) for off in offs], axis=-1)
    out = jnp.dot(cols, jnp.concatenate(taps, axis=0),
                  preferred_element_type=jnp.float32).astype(x.dtype)
  else:
    out = sum(jnp.dot(_shift(x, off), w,
                      preferred_element_type=jnp.float32).astype(x.dtype)
              for off, w in zip(offs, taps))
  if bias is not None:
    out = out + bias
  return out


class Conv1D(nn.Module):
  """Drop-in for flax nn.Conv(features, (k,), kernel_dilation=(d,),
  padding='SAME') with identical parameter shapes/names."""
  features: int
  kernel_size: int
  dilation: int = 1
  use_bias: bool = True
  dtype: jnp.dtype | None = None

  @nn.compact
  def __call__(self, x: Array) -> Array:
    dtype = self.dtype or x.dtype
    kernel = self.param(
        'kernel', nn.initializers.lecun_normal(),
        (self.kernel_size, x.shape[-1], self.features))
    bias = (self.param('bias', nn.initializers.zeros,
                       (self.features,)) if self.use_bias else None)
    return conv1d_shifted(
        x.astype(dtype), kernel.astype(dtype),
        None if bias is None else bias.astype(dtype), self.dilation)
