"""Torch mirror of the reference's guided decode loops, driving the
reference's OWN CNNModel backbone.

This is the cross-framework end-to-end parity oracle (VERDICT r3 item
2): the reference's decode algorithms re-expressed in plain torch from
their documented semantics —

  controlled_sample loop          diffusion_gosai.py:1022-1062
  SVDD-MC update                  diffusion_gosai.py:1175-1228
  SVDD-PM (tweedie + heuristic)   diffusion_gosai.py:1374-1460
  TDS SMC update                  diffusion_gosai.py:1231-1284
  DPS update + gradient           diffusion_gosai.py:1286-1330
  classifier-guidance update      diffusion_gosai.py:1332-1371
  SUBS parameterization           diffusion_gosai.py:286-304
  forward/forward2 + sigma gating diffusion_gosai.py:328-380
  gumbel-trick categorical        diffusion_gosai.py:28-34
  loglinear noise schedule        noise_schedule.py:126-152

The backbone is a reference-layout torch mirror of
``models/dnaconv.py`` (tests/torch_mirrors.CNNModel) so the denoiser
weights can be carried into svdd through
importers.cnn and the two frameworks decode the *same model*. The
heavy Lightning module around these loops is unimportable here (no
lightning/hydra in this image), so the loop math lives in this file —
written fresh against the line-cited semantics, structured like the
reference (python loop over steps, sequential loop over the M
candidates) rather than like svdd's vectorized lax.scan.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MASK = 4
VOCAB = 5
NEG_INFINITY = -1_000_000.0


def loglinear_sigma(t: float, eps: float = 1e-3) -> float:
  """Total noise of the loglinear schedule (noise_schedule.py:144-145)."""
  return float(-np.log1p(-(1 - eps) * t))


def sample_categorical(probs: torch.Tensor) -> torch.Tensor:
  """Gumbel-trick draw ``argmax(p / (1e-10 - log(U + 1e-10)))``
  (diffusion_gosai.py:28-34)."""
  gumbel_norm = 1e-10 - (torch.rand_like(probs) + 1e-10).log()
  return (probs / gumbel_norm).argmax(dim=-1)


def subs_parameterization(logits: torch.Tensor,
                          xt: torch.Tensor) -> torch.Tensor:
  """Zero-mask-prob + carry-over-unmasked normalization
  (diffusion_gosai.py:286-304). where-based (not in-place) so torch
  autograd flows for the DPS path the same way jax.grad does."""
  mask_pen = torch.zeros(VOCAB, dtype=logits.dtype)
  mask_pen[MASK] = NEG_INFINITY
  logits = logits + mask_pen
  logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
  pinned = torch.where(
      F.one_hot(xt.clamp(0, VOCAB - 1), VOCAB).bool(),
      torch.zeros((), dtype=logits.dtype),
      torch.full((), NEG_INFINITY, dtype=logits.dtype))
  unmasked = (xt != MASK)[..., None]
  return torch.where(unmasked, pinned, logits)


class TorchDenoiser:
  """forward / forward2 of the reference Diffusion module around a raw
  CNNModel backbone (diffusion_gosai.py:339-380), including the
  time_conditioning=False sigma zeroing (:328-337, the Gosai configs'
  default)."""

  def __init__(self, backbone, time_conditioning: bool = False):
    self.backbone = backbone
    self.time_conditioning = time_conditioning

  def _sigma(self, x: torch.Tensor, sigma: float) -> torch.Tensor:
    if not self.time_conditioning:
      sigma = 0.0
    return torch.full((x.shape[0],), float(sigma))

  def forward(self, x: torch.Tensor, sigma: float) -> torch.Tensor:
    with torch.no_grad():
      logits = self.backbone(x, self._sigma(x, sigma))
    return subs_parameterization(logits, x)

  def forward2(self, x_onehot: torch.Tensor, x: torch.Tensor,
               sigma: float) -> torch.Tensor:
    logits = self.backbone.forward2(x_onehot, self._sigma(x, sigma))
    return subs_parameterization(logits, x)


def transform_samples(samples: torch.Tensor) -> torch.Tensor:
  """Tokens -> 4-channel one-hot with MASK rows zeroed
  (diffusion_gosai.py:1462-1470)."""
  keep = (samples != MASK)
  onehot = F.one_hot(samples.clamp(0, 3), 4).float()
  return onehot * keep[..., None].float()


def _q_xs(log_p_x0: torch.Tensor, mct: float, mcs: float) -> torch.Tensor:
  """q_xs = p_x0 (mct - mcs); q_xs[..., MASK] = mcs
  (diffusion_gosai.py:1185-1197)."""
  q = log_p_x0.exp() * (mct - mcs)
  q[:, :, MASK] = mcs
  return q


def _move_chances(t: float, t_next: float, noise_eps: float = 1e-3):
  sigma_t = loglinear_sigma(t, noise_eps)
  sigma_s = loglinear_sigma(t_next, noise_eps)
  mct = 1 - np.exp(-sigma_t)
  mcs = 1 - np.exp(-sigma_s)
  return sigma_t, sigma_s, mct, mcs


def _posterior_onehot(log_p: torch.Tensor,
                      samples: torch.Tensor) -> torch.Tensor:
  """Tweedie r(E[x0|x]) input: posterior argmax at masked positions,
  actual tokens elsewhere (diffusion_gosai.py:1414-1419)."""
  arg = log_p.argmax(dim=-1).clamp(0, 3)
  posterior = F.one_hot(arg, 4).float()
  copy = (samples != MASK).float()[..., None]
  actual = F.one_hot(samples.clamp(0, 3), 4).float()
  return copy * actual + (1 - copy) * posterior


def get_score(denoiser: TorchDenoiser, x: torch.Tensor,
              sigma: float) -> torch.Tensor:
  """SUBS score exp(log p_t(y)/p_t(x)) (diffusion_gosai.py:1581-1624)."""
  log_p = denoiser.forward(x, sigma)
  log_k = float(-np.log(np.expm1(sigma)))
  masked_score = log_p + log_k
  masked_score[:, :, MASK] = 0
  unmasked_score = torch.full_like(log_p, NEG_INFINITY)
  unmasked_score = torch.scatter(
      unmasked_score, -1, x[..., None],
      torch.zeros_like(unmasked_score[..., :1]))
  unmasked_score[:, :, MASK] = -log_k
  masked = (x == MASK)[..., None].float()
  return (masked_score * masked + unmasked_score * (1 - masked)).exp()


def staggered_score(score: torch.Tensor, dsigma: float) -> torch.Tensor:
  """(diffusion_gosai.py:1626-1631)."""
  score = score.clone()
  extra = (1 - np.exp(dsigma)) * score.sum(dim=-1)
  score = score * np.exp(dsigma)
  score[..., MASK] += extra
  return score


def transp_transition(i: torch.Tensor, sigma: float) -> torch.Tensor:
  """(diffusion_gosai.py:1651-1658)."""
  edge = np.exp(-sigma) * F.one_hot(i, num_classes=VOCAB).float()
  edge = edge + torch.where(i == MASK, 1 - np.exp(-sigma),
                            0.0)[..., None]
  return edge


def decode_analytic(denoiser: TorchDenoiser, batch_size: int,
                    length: int, num_steps: int,
                    eps: float = 1e-5) -> torch.Tensor:
  """Uncontrolled analytic (score-based) sampler + denoiser noise
  removal (diffusion_gosai.py:1633-1649; loop scaffold :821-886)."""
  x = torch.full((batch_size, length), MASK, dtype=torch.long)
  timesteps = np.linspace(1.0, eps, num_steps + 1)
  for i in range(num_steps):
    curr = loglinear_sigma(float(timesteps[i]))
    nxt = loglinear_sigma(float(timesteps[i + 1]))
    score = get_score(denoiser, x, curr)
    probs = staggered_score(score, curr - nxt) \
        * transp_transition(x, curr - nxt)
    x = sample_categorical(probs)
  sigma = loglinear_sigma(float(timesteps[-1]))
  probs = staggered_score(get_score(denoiser, x, sigma), sigma) \
      * transp_transition(x, sigma)
  probs[..., MASK] = 0
  return sample_categorical(probs)


def decode(denoiser: TorchDenoiser, algo: str, batch_size: int,
           length: int, num_steps: int, *, value_fn=None,
           reward_fn=None, sample_M: int = 10, alpha: float = 1.0,
           guidance_scale: float = 1.0, tweedie: bool = True,
           m_schedule=None, eps: float = 1e-5) -> torch.Tensor:
  """The reference decode loop (diffusion_gosai.py:1022-1062 scaffold
  shared by every controlled_sample_* variant): all-MASK prior,
  timesteps linspace(1, eps, steps+1), per-step guided update, final
  noise-removal argmax over the non-mask vocab (:1049-1060).

  value_fn: (N, L) tokens -> (N,) scores (SVDD-MC / classifier —
            classifier additionally differentiates through it on the
            4-channel one-hot, so it must accept one-hot input too).
  reward_fn: (N, L, 4) one-hot -> (N,) (SVDD-PM / TDS / DPS).
  """
  x = torch.full((batch_size, length), MASK, dtype=torch.long)
  timesteps = np.linspace(1.0, eps, num_steps + 1)
  # scheduled-M: expand [(n_steps, M), ...] to a per-step M list
  # (mirrors svdd's phased reverse_process)
  if m_schedule is not None:
    per_step_m = [m for n, m in m_schedule for _ in range(n)]
    assert len(per_step_m) == num_steps
  else:
    per_step_m = [sample_M] * num_steps

  for i in range(num_steps):
    t, t_next = float(timesteps[i]), float(timesteps[i + 1])
    sigma_t, sigma_s, mct, mcs = _move_chances(t, t_next)
    copy_flag = (x != MASK).long()

    if algo in ('mc', 'pm'):
      log_p = denoiser.forward(x, sigma_t)
      q_xs = _q_xs(log_p, mct, mcs)
      # M sequential draws + M sequential scorer forwards, the
      # reference's own structure (:1203-1209)
      samples, scores = [], []
      for _ in range(per_step_m[i]):
        cand = copy_flag * x + (1 - copy_flag) * sample_categorical(q_xs)
        samples.append(cand)
        if algo == 'mc':
          scores.append(value_fn(cand))
        elif tweedie:
          cand_log_p = denoiser.forward(cand, sigma_s)
          scores.append(reward_fn(_posterior_onehot(cand_log_p, cand)))
        else:                      # mask-to-zero heuristic (:1420-1424)
          scores.append(reward_fn(transform_samples(cand)))
      idx = torch.stack(scores, dim=1).softmax(dim=1).argmax(dim=1)
      x = torch.stack([samples[idx[j]][j] for j in range(batch_size)])

    elif algo == 'tds':
      log_p = denoiser.forward(x, sigma_t)
      q_xs = _q_xs(log_p, mct, mcs)
      sample = copy_flag * x + (1 - copy_flag) * sample_categorical(q_xs)
      log_p_sample = denoiser.forward(sample, sigma_s)
      reward_num = reward_fn(_posterior_onehot(log_p_sample, sample))
      log_p_x = denoiser.forward(x, sigma_s)          # (:1274, sigma_s)
      reward_den = reward_fn(_posterior_onehot(log_p_x, x))
      ratio = torch.exp((reward_num - reward_den) / alpha).numpy()
      idx = np.random.choice(batch_size, batch_size,
                             p=ratio / ratio.sum())   # (:1282)
      x = sample[torch.as_tensor(idx)]

    elif algo == 'dps':
      # gradient of r(softmax(E[x0|xt])) wrt the FULL 5-channel one-hot
      # through forward2, mask-column re-centered exp tilt (:1286-1330)
      x_onehot = F.one_hot(x, VOCAB).float().requires_grad_(True)
      copy = copy_flag.float()[..., None]
      expected = denoiser.forward2(x_onehot, x, sigma_s)
      expected = copy * x_onehot + (1 - copy) * expected
      probs = expected.softmax(dim=-1)
      reward_fn(probs[..., :4]).mean().backward()
      x_grad = x_onehot.grad
      with torch.no_grad():
        log_p = denoiser.forward(x, sigma_t)
        q_xs = _q_xs(log_p, mct, mcs)
        guidance = guidance_scale * (
            x_grad - x_grad[:, :, MASK][:, :, None])
        draw = sample_categorical(q_xs * guidance.exp())
        x = copy_flag * x + (1 - copy_flag) * draw

    elif algo == 'classifier':
      # grad of the value net wrt the 4-channel one-hot, zero-padded
      # and added to q_xs in PROBABILITY space (:1332-1371)
      oh = transform_samples(x).requires_grad_(True)
      value_fn(oh).mean().backward()
      x_grad = torch.cat([oh.grad, torch.zeros_like(oh.grad[..., :1])],
                         dim=-1)
      with torch.no_grad():
        log_p = denoiser.forward(x, sigma_t)
        q_xs = _q_xs(log_p, mct, mcs)
        draw = sample_categorical(q_xs + guidance_scale * x_grad)
        x = copy_flag * x + (1 - copy_flag) * draw

    elif algo == 'baseline':
      log_p = denoiser.forward(x, sigma_t)
      q_xs = _q_xs(log_p, mct, mcs)
      x = copy_flag * x + (1 - copy_flag) * sample_categorical(q_xs)

    else:
      raise ValueError(algo)

  # noise removal (:1049-1060)
  logits = denoiser.forward(x, loglinear_sigma(float(timesteps[-1])))
  return logits[:, :, :-1].argmax(dim=-1)
