"""Value-network training (MC and CD-Q).

Rebuild of the reference's hand-rolled value trainer (reference
trainer.py:52-260 + the self-generating forward in Enformer.py:163-267):
each step samples a full trajectory from the FROZEN diffusion model,
builds regression targets (MC: final reward for every intermediate
state; CD-Q: bootstrapped candidate-mean values), and takes one AdamW
step on the value net.

Design: trajectory generation + target construction + the value-net
grad step are jitted programs per iteration — the reference's AMP
GradScaler is unnecessary (bf16 keeps f32's exponent range, so it
needs no loss scaling), and the token-based warmup + cosine decay LR
(trainer.py:211-223) maps to an optax schedule on the same token count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from svdd import utils, value as value_lib
from svdd.config import Config
from svdd.diffusion import Diffusion

LOGGER = utils.get_logger(__name__)


class ValueTrainState(NamedTuple):
  step: jnp.ndarray
  params: Any
  extras: Any
  opt_state: Any
  rng: jax.Array
  tokens: jnp.ndarray   # token counter for the LR schedule


@dataclasses.dataclass
class ValueTrainerConfig:
  """(reference trainer.py TrainerConfig:25-50)."""
  learning_rate: float = 3e-4
  betas: tuple = (0.9, 0.95)
  grad_norm_clip: float = 1.0
  weight_decay: float = 0.1
  lr_decay: bool = False
  warmup_tokens: float = 375e2
  final_tokens: float = 260e7
  max_iter: int = 50_000
  cdq: bool = False
  batch_size: int = 32
  eval_every: int = 200
  # train on a random subset of intermediate timesteps per iteration
  # (None = all, the reference behavior); big value nets need this to
  # keep the grad step's activations within device memory
  mc_subsample: Optional[int] = None
  tokens_per_iter: float = 32 * 128 * 200 * 4   # (trainer.py:213)
  # reward-target input routing: rna_saluki builds the (N, 12288, 6)
  # oracle input for the TARGET while the value net keeps seeing
  # (N, L, 4) states (Enformer.py:195-196)
  task: str = 'dna'
  saluki_final_length: int = 12288


class ValueTrainer:
  """Drives value-net fitting against a frozen Diffusion model.

  ``mesh`` distributes the self-generated workload the way the
  reference's NCCL DDP / DataParallel value training does
  (reference train.py:36-45,295-300; trainer.py:65-71): the
  trajectory batch and every regression row shard over the 'data'
  axis, and pjit inserts the gradient psum (the DDP all-reduce).
  ``fsdp=True`` additionally shards value-net params + optimizer state
  over 'data' (ZeRO-style — beyond the reference, whose value nets are
  always fully replicated)."""

  def __init__(self, diffusion: Diffusion, vf: value_lib.ValueFunction,
               reward_fn, tcfg: ValueTrainerConfig,
               sample_M: int = 10, saluki_body=None,
               mesh=None, fsdp: bool = False,
               fsdp_min_size: int = 2 ** 14):
    # sample_M kept for CLI-surface parity (the reference's train.py
    # accepts it; MC/CDQ training itself doesn't branch on it)
    self.diffusion = diffusion
    self.vf = vf
    # reward_fn may be a plain callable or a hoisted
    # (apply_fn, variables) pair (RewardOracle.as_pair) — the pair's
    # weights ride into the jitted grad step as ARGUMENTS so they are
    # never inlined as HLO constants
    self._reward_apply, self._reward_vars = value_lib.split_reward_fn(
        reward_fn)
    self.tcfg = tcfg
    self.sample_M = sample_M
    self.mesh = mesh
    self.fsdp = fsdp
    self.fsdp_min_size = fsdp_min_size
    self._reward_transform = value_lib.make_reward_transform(
        tcfg.task, saluki_body, tcfg.saluki_final_length)

    sched = (self._token_schedule() if tcfg.lr_decay
             else tcfg.learning_rate)
    self.opt = optax.chain(
        optax.clip_by_global_norm(tcfg.grad_norm_clip),
        optax.adamw(sched, b1=tcfg.betas[0], b2=tcfg.betas[1],
                    weight_decay=tcfg.weight_decay),
    )
    if tcfg.cdq:
      self._sampler = diffusion.cdq_sampler(
          tcfg.batch_size, repeats=10, mesh=mesh)
    else:
      self._sampler = diffusion.sampler(tcfg.batch_size,
                                        collect_mid=True, mesh=mesh)
    # trajectory generation and the value grad step are SEPARATE jitted
    # programs, which keeps each compile unit moderate for the full
    # Enformer value net; state is not donated.
    self._grad_step = jax.jit(self._make_grad_step())
    self._sample_key = jax.random.key(0)

  def _token_schedule(self):
    t = self.tcfg
    def sched(step):
      tokens = step * t.tokens_per_iter
      return t.learning_rate * utils.token_cosine_lr_mult(
          tokens, t.warmup_tokens, t.final_tokens)
    return sched

  def init_state(self, rng: jax.Array) -> ValueTrainState:
    # deep-copy: the donated train step must not invalidate vf.variables
    variables = jax.tree.map(lambda x: jnp.array(x, copy=True),
                             dict(self.vf.variables))
    params = variables.pop('params')
    opt_state = self.opt.init(params)
    if self.mesh is not None:
      from svdd.parallel import mesh as M
      if self.fsdp:
        params = M.fsdp_shard(params, self.mesh, self.fsdp_min_size)
        opt_state = M.fsdp_shard(opt_state, self.mesh,
                                 self.fsdp_min_size)
      else:
        params = M.replicate(params, self.mesh)
        opt_state = M.replicate(opt_state, self.mesh)
      variables = M.replicate(variables, self.mesh)
    return ValueTrainState(jnp.asarray(0), params, variables,
                           opt_state, rng, jnp.asarray(0.0))

  def _train_step(self, state: ValueTrainState, _):
    """One iteration: sample a trajectory (program 1), then the value
    grad step on its states (program 2)."""
    self._sample_key, sub = jax.random.split(self._sample_key)
    res = self._sampler(sub)
    extra = res.extra if self.tcfg.cdq else ()
    return self._grad_step(state, res.samples, res.mid_x, extra,
                           self._reward_vars)

  def _shard_rows(self, batch):
    """Pin every regression row to the 'data' mesh axis so the value
    forward/backward splits across devices (the DDP data split,
    reference trainer.py:65-71); pjit then psums the grads."""
    if self.mesh is None:
      return batch
    from jax.sharding import NamedSharding, PartitionSpec as P
    from svdd.parallel import mesh as M
    def sh(x):
      spec = P(M.DATA_AXIS, *([None] * (x.ndim - 1)))
      return jax.lax.with_sharding_constraint(
          x, NamedSharding(self.mesh, spec))
    # tree-map (None leaves are skipped by the pytree) so a new
    # ValueBatch field can never be silently dropped here
    return jax.tree.map(sh, batch)

  def _make_grad_step(self):
    module = self.vf.module
    has_stats = 'batch_stats' in self.vf.variables

    def step(state: ValueTrainState, samples, mid_x, cdq_candidates,
             reward_vars):
      rng, k_drop, k_sub = jax.random.split(state.rng, 3)
      reward_fn = lambda x: self._reward_apply(reward_vars, x)
      if self.tcfg.cdq:
        # bootstrap targets use the CURRENT (stop-gradient) value net
        frozen_value = lambda oh: module.apply(
            {'params': state.params, **state.extras}, oh)
        batch = value_lib.cdq_targets(
            samples, mid_x, cdq_candidates, reward_fn,
            frozen_value, reward_transform=self._reward_transform)
      else:
        batch = value_lib.mc_targets(
            samples, mid_x, reward_fn, subsample_key=k_sub,
            num_subsample=self.tcfg.mc_subsample,
            reward_transform=self._reward_transform)
      batch = self._shard_rows(batch)

      # timed models take per-state step indices (the reference's
      # TimedEnformer training loop feeds torch.full((B,L), i),
      # Enformer.py:204-215; mc_targets carries the same indices)
      extra_in = ((batch.time_indices,)
                  if self.vf.timed and batch.time_indices is not None
                  else ())

      def loss_fn(params):
        variables = {'params': params, **state.extras}
        if has_stats:
          preds, updates = module.apply(
              variables, batch.onehots, *extra_in, train=True,
              mutable=['batch_stats'], rngs={'dropout': k_drop})
        else:
          preds = module.apply(variables, batch.onehots, *extra_in,
                               train=True, rngs={'dropout': k_drop})
          updates = {}
        loss = jnp.mean((preds.reshape(-1)
                         - batch.targets.reshape(-1)) ** 2)
        return loss, updates

      (loss, updates), grads = jax.value_and_grad(
          loss_fn, has_aux=True)(state.params)
      upd, opt_state = self.opt.update(grads, state.opt_state,
                                       state.params)
      params = optax.apply_updates(state.params, upd)
      extras = {**state.extras, **updates}
      return ValueTrainState(
          state.step + 1, params, extras, opt_state, rng,
          state.tokens + self.tcfg.tokens_per_iter), loss

    return step

  def train(self, state: ValueTrainState, num_iters: int,
            log_every: int = 50) -> ValueTrainState:
    t0 = time.time()
    for i in range(num_iters):
      state, loss = self._train_step(state, None)
      if int(state.step) % log_every == 0:
        LOGGER.info('value step %d MSE %.5f (%.2f it/s)',
                    int(state.step), float(loss),
                    log_every / max(time.time() - t0, 1e-9))
        t0 = time.time()
    return state

  def updated_value_function(self, state: ValueTrainState
                             ) -> value_lib.ValueFunction:
    return value_lib.ValueFunction(
        self.vf.module, {'params': state.params, **state.extras},
        self.vf.length, self.vf.timed)

  # -- full trainer-state checkpointing (reference trainer.py:73-96
  #    saves {model, optimizer, scaler, tokens, best_loss, epoch};
  #    bf16 needs no GradScaler, the rest round-trips here) -------------

  def save_state(self, path: str, state: ValueTrainState) -> None:
    from svdd.checkpoint import save_pytree
    save_pytree(path, {
        'step': state.step, 'params': state.params,
        'extras': state.extras, 'opt_state': state.opt_state,
        'rng': jax.random.key_data(state.rng),
        'tokens': state.tokens,
    })

  def restore_state(self, path: str, rng: jax.Array
                    ) -> ValueTrainState:
    """Resume mid-run: optimizer moments, token counter for the LR
    schedule, and the RNG stream all continue."""
    from svdd.checkpoint import load_pytree
    template = self.init_state(rng)
    tree = load_pytree(path, {
        'step': template.step, 'params': template.params,
        'extras': template.extras, 'opt_state': template.opt_state,
        'rng': jax.random.key_data(template.rng),
        'tokens': template.tokens,
    })
    return ValueTrainState(
        jnp.asarray(tree['step']), tree['params'], tree['extras'],
        tree['opt_state'], jax.random.wrap_key_data(tree['rng']),
        jnp.asarray(tree['tokens']))

  # -- per-timestep eval (Enformer.py evaluate_seq_step:318-341) ------------

  def evaluate_seq_step(self, state: ValueTrainState,
                        eval_batches, eval_targets):
    """Per-timestep MSE + PearsonR over pre-generated eval batches."""
    losses, pearsons = [], []
    variables = {'params': state.params, **state.extras}
    for onehots, target in zip(eval_batches, eval_targets):
      preds = np.asarray(self.vf.module.apply(variables, onehots))
      y = np.asarray(target).reshape(-1)
      p = preds.reshape(-1)
      losses.append(float(np.mean((p - y) ** 2)))
      denom = p.std() * y.std()
      pearsons.append(float(np.mean((p - p.mean()) * (y - y.mean()))
                            / denom) if denom > 0 else 0.0)
    return losses, pearsons


class MultiSepTrainer:
  """Trains the time-binned MultiSep value model (reference
  train.py --model multienformer -> BaseModelMultiSep.forward, which
  returns per-bin losses; trainer.py:184-189 'multi_model' mode).

  All bins update in one jitted step: trajectory states are sliced by
  bin and each bin's trunk regresses onto the shared final reward."""

  def __init__(self, diffusion: Diffusion, msm, reward_fn,
               tcfg: ValueTrainerConfig, saluki_body=None, mesh=None):
    from svdd.models import multisep as ms
    self.diffusion = diffusion
    self.msm = msm
    self._reward_apply, self._reward_vars = value_lib.split_reward_fn(
        reward_fn)
    self.tcfg = tcfg
    self.mesh = mesh
    self._reward_transform = value_lib.make_reward_transform(
        tcfg.task, saluki_body, tcfg.saluki_final_length)
    self.opt = optax.adamw(tcfg.learning_rate)
    self._sampler = diffusion.sampler(tcfg.batch_size,
                                      collect_mid=True, mesh=mesh)
    self._multisep_losses = ms.multisep_losses
    self._train_step = jax.jit(self._make_step(), donate_argnums=(0,))

  def init_state(self, rng: jax.Array):
    dummy = jnp.zeros((1, self.diffusion.config.model.length, 4))
    stacked = self.msm.init(rng, dummy)
    stacked = jax.tree.map(lambda x: jnp.array(x, copy=True), stacked)
    opt_state = self.opt.init(stacked)
    if self.mesh is not None:
      from svdd.parallel import mesh as M
      stacked = M.replicate(stacked, self.mesh)
      opt_state = M.replicate(opt_state, self.mesh)
    return (jnp.asarray(0), stacked, opt_state, rng)

  def _make_step(self):
    from svdd import mdlm as _mdlm

    def step(state, reward_vars):
      it, stacked, opt_state, rng = state
      rng, k = jax.random.split(rng)
      res = self._sampler(k)
      states = jnp.concatenate(
          [res.mid_x, res.samples[None]], axis=0)          # (S, B, L)
      onehots = _mdlm.transform_samples(states)            # (S, B, L, 4)
      targets = self._reward_apply(
          reward_vars, self._reward_transform(res.samples))
      if self.mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from svdd.parallel import mesh as M
        onehots = jax.lax.with_sharding_constraint(
            onehots, NamedSharding(self.mesh,
                                   P(None, M.DATA_AXIS, None, None)))
        targets = jax.lax.with_sharding_constraint(
            targets, NamedSharding(self.mesh, P(M.DATA_AXIS)))

      def loss_fn(sv):
        losses = self._multisep_losses(self.msm, sv, onehots, targets)
        return losses.mean(), losses

      (loss, losses), grads = jax.value_and_grad(
          loss_fn, has_aux=True)(stacked)
      upd, opt_state = self.opt.update(grads, opt_state, stacked)
      stacked = optax.apply_updates(stacked, upd)
      return (it + 1, stacked, opt_state, rng), (loss, losses)

    return step

  def save_state(self, path: str, state) -> None:
    from svdd.checkpoint import save_pytree
    it, stacked, opt_state, rng = state
    save_pytree(path, {'step': it, 'stacked': stacked,
                       'opt_state': opt_state,
                       'rng': jax.random.key_data(rng)})

  def restore_state(self, path: str, rng: jax.Array):
    from svdd.checkpoint import load_pytree
    it, stacked, opt_state, rng0 = self.init_state(rng)
    tree = load_pytree(path, {
        'step': it, 'stacked': stacked, 'opt_state': opt_state,
        'rng': jax.random.key_data(rng0)})
    return (jnp.asarray(tree['step']), tree['stacked'],
            tree['opt_state'], jax.random.wrap_key_data(tree['rng']))

  def train(self, state, num_iters: int, log_every: int = 50):
    for i in range(num_iters):
      state, (loss, losses) = self._train_step(state,
                                               self._reward_vars)
      if int(state[0]) % log_every == 0:
        LOGGER.info('multisep step %d mean MSE %.5f (per-bin %s)',
                    int(state[0]), float(loss),
                    np.round(np.asarray(losses), 4).tolist())
    return state


def build_eval_timestep_batches(diffusion: Diffusion, reward_fn,
                                batch_size: int, val_batch_num: int,
                                key: jax.Array, task: str = 'dna',
                                saluki_body=None,
                                saluki_final_length: int = 12288):
  """Pre-generate per-timestep eval batches by sampling the diffusion
  model full-depth (BaseModel.__init__, Enformer.py:135-160):
  returns (eval_batches[t], eval_targets[t]) for t in 0..S-1.
  rna_saluki routes the TARGET through the saluki input builder
  (Enformer.py:142-143); eval states stay 4-channel."""
  from svdd import mdlm
  reward_fn = value_lib.as_reward_callable(reward_fn)
  reward_transform = value_lib.make_reward_transform(
      task, saluki_body, saluki_final_length)
  sampler = diffusion.sampler(batch_size, collect_mid=True)
  steps = diffusion.config.sampling.steps
  all_samples = [[] for _ in range(steps)]
  all_targets = [[] for _ in range(steps)]
  for i in range(val_batch_num):
    key, sub = jax.random.split(key)
    res = sampler(sub)
    target = reward_fn(reward_transform(res.samples))
    states = list(res.mid_x) + [res.samples]
    for t, s in enumerate(states):
      all_samples[t].append(mdlm.transform_samples(s))
      all_targets[t].append(target)
  eval_batches = [jnp.concatenate(s) for s in all_samples]
  eval_targets = [jnp.concatenate(t) for t in all_targets]
  return eval_batches, eval_targets
