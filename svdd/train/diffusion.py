"""MDLM diffusion pretraining loop.

Counterpart of the reference's Lightning pipeline
(reference main_gosai.py:159-202 + the LightningModule training
hooks in diffusion_gosai.py): optax AdamW + grad clip (configs_gosai/
config_gosai.yaml optim/trainer blocks), constant-warmup or
cosine-decay LR (configs_gosai/lr_scheduler/*), EMA updated after every
optimizer step (diffusion_gosai.py:279-284), bf16 compute, periodic
validation NLL + sample-quality metrics, orbax checkpointing carrying
EMA + optimizer + fault-tolerant iterator state (SURVEY.md §5
checkpoint semantics).

The step is one donated jit: grads are psum'd over the 'data' mesh axis
by pjit (the DDP all-reduce), params optionally FSDP-sharded.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Iterator, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from svdd import utils
from svdd.checkpoint import orbax
from svdd.config import Config
from svdd.diffusion import Diffusion
from svdd.models import ema as ema_lib

LOGGER = utils.get_logger(__name__)


class TrainState(NamedTuple):
  step: jnp.ndarray
  params: Any
  extras: Any          # non-trained collections (buffers, batch_stats)
  opt_state: Any
  ema: ema_lib.EMAState
  rng: jax.Array


def make_optimizer(config: Config) -> optax.GradientTransformation:
  o = config.optim
  if o.lr_schedule == 'cosine_decay_warmup':
    sched = utils.cosine_decay_warmup_schedule(
        o.lr, o.warmup_steps, o.max_steps, o.lr_min)
  else:
    sched = utils.constant_warmup_schedule(o.lr, o.warmup_steps)
  return optax.chain(
      optax.clip_by_global_norm(o.grad_clip),
      optax.adamw(sched, b1=o.beta1, b2=o.beta2, eps=o.eps,
                  weight_decay=o.weight_decay),
  )


def init_state(model: Diffusion, config: Config,
               rng: jax.Array) -> TrainState:
  # deep-copy so the donated train-step buffers never alias
  # model.variables (which outlives the train state)
  variables = jax.tree.map(lambda x: jnp.array(x, copy=True),
                           dict(model.variables))
  params = variables.pop('params')
  opt = make_optimizer(config)
  return TrainState(
      step=jnp.asarray(0),
      params=params,
      extras=variables,
      opt_state=opt.init(params),
      ema=ema_lib.init(params, config.training.ema),
      rng=rng,
  )


def _pipeline_apply_fn(model: Diffusion, config: Config, mesh):
  """Build the pipelined denoiser forward when configured (else None).
  Wires parallel/pipeline.py into the (text-MDLM/DiT) training loop."""
  stages = config.parallel.pipeline_stages
  if stages <= 1:
    return None
  if config.backbone != 'dit':
    raise ValueError('pipeline_stages>1 supports the dit backbone '
                     f'only (got {config.backbone!r})')
  if mesh is None or 'pipe' not in mesh.shape:
    raise ValueError("pipeline_stages>1 needs a mesh with a 'pipe' "
                     'axis (parallel.pipeline.PIPE_AXIS)')
  if mesh.shape['pipe'] != stages:
    raise ValueError(f"mesh 'pipe' axis {mesh.shape['pipe']} != "
                     f'pipeline_stages {stages}')
  from svdd.parallel.pipeline import pipelined_backbone_apply
  return pipelined_backbone_apply(
      model.backbone, mesh=mesh,
      num_microbatches=config.parallel.pipeline_microbatches,
      virtual=config.parallel.pipeline_virtual)


def make_train_step(model: Diffusion, config: Config, mesh=None):
  opt = make_optimizer(config)
  accum = max(1, getattr(config.training, 'accum_steps', 1))
  apply_fn = _pipeline_apply_fn(model, config, mesh)

  def microbatch_grads(params, extras, batch, loss_key, drop_key):
    def loss_fn(params):
      variables = {'params': params, **extras}
      out = model.loss(variables, loss_key, batch['seqs'],
                       batch.get('attention_mask'), train=True,
                       dropout_rng=drop_key, apply_fn=apply_fn)
      return out.loss
    return jax.value_and_grad(loss_fn)(params)

  def train_step(state: TrainState, batch):
    rng, loss_key, drop_key = jax.random.split(state.rng, 3)

    if accum == 1:
      loss, grads = microbatch_grads(state.params, state.extras, batch,
                                     loss_key, drop_key)
    else:
      # grad accumulation: scan over `accum` microbatches (batch axis
      # must divide), averaging loss+grads before the single update.
      # Each microbatch gets independent t-draw and dropout keys.
      def split_mb(x):
        return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
      mbs = jax.tree.map(split_mb, batch)
      keys = (jax.random.split(loss_key, accum),
              jax.random.split(drop_key, accum))

      def body(carry, xs):
        loss_sum, grad_sum = carry
        mb, (lk, dk) = xs
        loss, grads = microbatch_grads(state.params, state.extras,
                                       mb, lk, dk)
        return (loss_sum + loss,
                jax.tree.map(jnp.add, grad_sum, grads)), None

      zero = (jnp.zeros(()),
              jax.tree.map(jnp.zeros_like, state.params))
      (loss, grads), _ = jax.lax.scan(body, zero, (mbs, keys))
      loss = loss / accum
      grads = jax.tree.map(lambda g: g / accum, grads)

    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    ema = ema_lib.update(state.ema, params)
    return TrainState(state.step + 1, params, state.extras, opt_state,
                      ema, rng), loss

  return train_step


def make_eval_step(model: Diffusion, config: Config, mesh=None):
  apply_fn = _pipeline_apply_fn(model, config, mesh)

  def eval_step(state: TrainState, batch, key):
    params = ema_lib.params(state.ema) \
        if not config.eval.disable_ema else state.params
    variables = {'params': params, **state.extras}
    out = model.loss(variables, key, batch['seqs'],
                     batch.get('attention_mask'), apply_fn=apply_fn)
    return out.nlls.sum(), out.token_mask.sum()
  return eval_step


@dataclasses.dataclass
class Trainer:
  """Train/eval/checkpoint driver (reference _train, main_gosai.py:159).

  mesh=None runs single-device; with a mesh, batches are sharded over
  'data' and (optionally) params over 'data' for FSDP.
  """
  model: Diffusion
  config: Config
  mesh: Any = None
  ckpt_dir: Optional[str] = None
  # observability (VERDICT r1 item 5): metrics sink + in-training
  # sample-quality hook. The reference logs from every entry point
  # (wandb, decode.py:55, trainer.py:140) and computes Wasserstein /
  # k-mer / emb-PCA metrics every validation epoch
  # (diffusion_gosai.py:451-565).
  logger: Any = None                 # observability.MetricsLogger
  sample_eval_fn: Any = None         # (ema_variables, key) -> dict

  def __post_init__(self):
    self.train_step = jax.jit(
        make_train_step(self.model, self.config, self.mesh),
        donate_argnums=(0,))
    self.eval_step = jax.jit(
        make_eval_step(self.model, self.config, self.mesh))
    self._mgr = None
    self._best_mgr = None

  def _manager(self):
    """Persistent ASYNC orbax CheckpointManager: saves return
    immediately and write in a background thread (the reference's
    Lightning callbacks block the step loop); multi-host saves
    coordinate automatically through orbax's multiprocess barrier when
    jax.distributed is initialized."""
    if self._mgr is None:
      ocp = orbax()
      self._mgr = ocp.CheckpointManager(
          os.path.abspath(self.ckpt_dir),
          options=ocp.CheckpointManagerOptions(
              max_to_keep=3, enable_async_checkpointing=True))
    return self._mgr

  def save_async(self, state: TrainState,
                 iterator_state: dict | None = None) -> None:
    ocp = orbax()
    self._manager().save(int(state.step), args=ocp.args.Composite(
        state=ocp.args.PyTreeSave(state_to_tree(state, iterator_state))))

  def _best_manager(self):
    """Best-model retention on validation NLL, the reference's
    ModelCheckpoint(monitor='val/nll', mode='min')
    (main_gosai.py:193-198, configs_gosai/callbacks/
    checkpoint_monitor.yaml): a separate '<ckpt_dir>/best' manager
    keeping only the lowest-val/nll checkpoint alongside the
    step-cadence saves above."""
    if self._best_mgr is None:
      ocp = orbax()
      self._best_mgr = ocp.CheckpointManager(
          os.path.join(os.path.abspath(self.ckpt_dir), 'best'),
          options=ocp.CheckpointManagerOptions(
              max_to_keep=1,
              best_fn=lambda metrics: metrics['val_nll'],
              best_mode='min',
              enable_async_checkpointing=True))
    return self._best_mgr

  def save_best_async(self, state: TrainState, val_nll: float,
                      iterator_state: dict | None = None) -> None:
    ocp = orbax()
    self._best_manager().save(
        int(state.step),
        metrics={'val_nll': float(val_nll)},
        args=ocp.args.Composite(
            state=ocp.args.PyTreeSave(
                state_to_tree(state, iterator_state))))

  def finalize_checkpoints(self) -> None:
    if self._mgr is not None:
      self._mgr.wait_until_finished()
    if self._best_mgr is not None:
      self._best_mgr.wait_until_finished()

  def init_or_restore(self, rng: jax.Array, train_iter=None) -> TrainState:
    state = init_state(self.model, self.config, rng)
    if self.ckpt_dir and self.config.checkpointing.resume_from_ckpt:
      state = restore_checkpoint(self.ckpt_dir, state, train_iter)
    if self.mesh is not None:
      from svdd.parallel import mesh as M
      if self.config.parallel.fsdp:
        if M.DATA_AXIS not in self.mesh.shape:
          raise ValueError(
              "parallel.fsdp needs a 'data' mesh axis (pipe-only "
              'meshes replicate params; stage weights are already '
              'split by the GPipe shard_map)')
        ms = self.config.parallel.fsdp_min_size
        state = TrainState(
            state.step,
            M.fsdp_shard(state.params, self.mesh, ms),
            M.replicate(state.extras, self.mesh),
            M.fsdp_shard(state.opt_state, self.mesh, ms),
            ema_lib.EMAState(state.ema.decay, state.ema.num_updates,
                             M.fsdp_shard(state.ema.shadow, self.mesh,
                                          ms)),
            state.rng)
      else:
        state = TrainState(
            state.step, M.replicate(state.params, self.mesh),
            M.replicate(state.extras, self.mesh),
            M.replicate(state.opt_state, self.mesh),
            ema_lib.EMAState(state.ema.decay, state.ema.num_updates,
                             M.replicate(state.ema.shadow, self.mesh)),
            state.rng)
    return state

  def _put(self, batch):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if self.mesh is not None:
      from svdd.parallel import mesh as M
      if M.DATA_AXIS in self.mesh.shape:
        batch = M.shard_batch(batch, self.mesh)
      else:
        # pipe-only mesh: the GPipe shard_map microbatches the full
        # batch itself; feed it replicated
        batch = M.replicate(batch, self.mesh)
    return batch

  def fit(self, state: TrainState, train_iter: Iterator,
          valid_iter=None, num_steps: Optional[int] = None,
          log_every: int = 100, eval_every: Optional[int] = None,
          ckpt_every: Optional[int] = None) -> TrainState:
    num_steps = num_steps or self.config.optim.max_steps
    eval_every = eval_every or self.config.eval.val_check_interval
    ckpt_every = ckpt_every or self.config.checkpointing.every_n_steps
    it = iter(train_iter)
    t0 = time.time()
    for i in range(num_steps):
      batch = self._put(next(it))
      state, loss = self.train_step(state, batch)
      step = int(state.step)
      if step % log_every == 0:
        dt = time.time() - t0
        steps_per_s = log_every / max(dt, 1e-9)
        LOGGER.info('step %d loss %.4f (%.2f steps/s)', step,
                    float(loss), steps_per_s)
        if self.logger is not None:
          self.logger.log({'train/loss': float(loss),
                           'train/steps_per_s': steps_per_s}, step=step)
        t0 = time.time()
      if valid_iter is not None and step % eval_every == 0:
        nll = self.evaluate(state, valid_iter)
        LOGGER.info('step %d val/nll %.4f', step, nll)
        if self.logger is not None:
          self.logger.log({'val/nll': nll}, step=step)
        if self.ckpt_dir:
          self.save_best_async(
              state, nll,
              getattr(train_iter, 'state_dict', lambda: {})())
        if self.sample_eval_fn is not None:
          # EMA-swapped sample-quality validation, as the reference does
          # on every validation epoch (diffusion_gosai.py:451-459)
          ema_vars = {'params': ema_lib.params(state.ema),
                      **state.extras}
          qmetrics = self.sample_eval_fn(
              ema_vars, jax.random.fold_in(jax.random.key(17), step))
          LOGGER.info('step %d sample-quality: %s', step,
                      {k: round(float(v), 4)
                       for k, v in qmetrics.items()})
          if self.logger is not None:
            self.logger.log(qmetrics, step=step)
      if self.ckpt_dir and step % ckpt_every == 0:
        self.save_async(state,
                        getattr(train_iter, 'state_dict', lambda: {})())
      # fault-injection hook (scripts/probe_resume_fire.py): die
      # mid-run via exception propagation, async checkpoint
      # deliberately NOT finalized, exactly like a worker crash
      # between checkpoints
      crash_at = os.environ.get('SVDD_CRASH_AT_STEP')
      if crash_at and step >= int(crash_at):
        raise RuntimeError(
            f'SVDD_CRASH_AT_STEP fault injection: dying at step {step} '
            'with async checkpoints in flight')
    self.finalize_checkpoints()
    return state

  def evaluate(self, state: TrainState, valid_iter,
               max_batches: int = 8) -> float:
    total, count = 0.0, 0.0
    key = jax.random.key(0)
    for i, batch in zip(range(max_batches), iter(valid_iter)):
      key, sub = jax.random.split(key)
      nll, n = self.eval_step(state, self._put(batch), sub)
      total += float(nll)
      count += float(n)
    return total / max(count, 1.0)


# ---------------------------------------------------------------------------
# Checkpointing (orbax) — EMA + optimizer + iterator state in one tree,
# replacing the reference's two systems (Lightning ckpt callbacks +
# hand-rolled torch dicts, SURVEY.md §5).
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    iterator_state: dict | None = None) -> None:
  ocp = orbax()
  path = os.path.abspath(os.path.join(ckpt_dir, f'step_{int(state.step)}'))
  with ocp.CheckpointManager(
      os.path.abspath(ckpt_dir),
      options=ocp.CheckpointManagerOptions(max_to_keep=3)) as mgr:
    mgr.save(int(state.step), args=ocp.args.Composite(
        state=ocp.args.PyTreeSave(state_to_tree(state, iterator_state))))
  del path


_ITER_TEMPLATE = {'epoch': 0, 'counter': 0, 'seed': 0}


def state_to_tree(state: TrainState, iterator_state: dict | None) -> dict:
  # fixed iterator schema so save/restore trees always match even when
  # one side has no live iterator
  it = dict(_ITER_TEMPLATE)
  it.update(iterator_state or {})
  return {
      'step': state.step,
      'params': state.params,
      'extras': state.extras,
      'opt_state': state.opt_state,
      'ema_shadow': state.ema.shadow,
      'ema_num_updates': state.ema.num_updates,
      'rng': jax.random.key_data(state.rng),
      'iterator': it,
  }


def restore_best_checkpoint(ckpt_dir: str,
                            template: TrainState) -> TrainState:
  """Load the lowest-val/nll checkpoint kept by Trainer.save_best_async
  (reference ModelCheckpoint(monitor='val/nll') semantics,
  main_gosai.py:193-198). Falls back to the latest step-cadence
  checkpoint if no best/ subdir exists."""
  best_dir = os.path.join(os.path.abspath(ckpt_dir), 'best')
  if os.path.isdir(best_dir):
    return restore_checkpoint(best_dir, template)
  return restore_checkpoint(ckpt_dir, template)


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       train_iter=None) -> TrainState:
  ocp = orbax()
  ckpt_dir = os.path.abspath(ckpt_dir)
  if not os.path.isdir(ckpt_dir):
    return template
  with ocp.CheckpointManager(ckpt_dir) as mgr:
    step = mgr.latest_step()
    if step is None:
      return template
    tree = state_to_tree(template, train_iter.state_dict()
                         if train_iter is not None else {})
    restored = mgr.restore(step, args=ocp.args.Composite(
        state=ocp.args.PyTreeRestore(tree)))['state']
  if train_iter is not None and restored.get('iterator'):
    train_iter.load_state_dict(
        {k: int(v) if isinstance(v, (int, np.integer, np.ndarray))
         else v for k, v in restored['iterator'].items()})
  LOGGER.info('restored checkpoint at step %d', int(restored['step']))
  return TrainState(
      step=jnp.asarray(restored['step']),
      params=restored['params'],
      extras=restored['extras'],
      opt_state=restored['opt_state'],
      ema=ema_lib.EMAState(template.ema.decay,
                           jnp.asarray(restored['ema_num_updates']),
                           restored['ema_shadow']),
      rng=jax.random.wrap_key_data(restored['rng']),
  )
