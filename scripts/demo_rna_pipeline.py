"""Full RNA pipeline demo on real hardware: pretrain -> oracle ->
value net -> guided decode -> quantile report.

Reproduces the reference's complete workflow (README.md steps: pretrain
main_gosai, rna_MRL_oracle, train.py value fit, decode.py /
decode_tweedie.py) on the synthetic 5'UTR stand-in dataset, end to end
in one process, with TRAINED models — demonstrating that SVDD-MC and
SVDD-PM lift the reward distribution exactly as the reference's
log/*.npz baselines show for real data.

Writes:
  log/demo-rna-MRL.npz      (decoding/baseline keys, SVDD-MC)
  log/demo-rna-MRL_tw.npz   (SVDD-PM)
  log/demo_pipeline.json    (stage metrics)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from svdd import utils  # noqa: E402

utils.enable_compile_cache()

T0 = time.perf_counter()
RESULTS = {}


def phase(m):
  print(f'+{time.perf_counter()-T0:7.1f}s {m}', flush=True)


from svdd import mdlm, rewards, value as value_lib
from svdd.config import rna_config
from svdd.data.gosai import FaultTolerantIterator, GosaiDataset
from svdd.decode import run_decode
from svdd.diffusion import Diffusion
from svdd.eval.metrics import kmer_pearson, quantile_report
from svdd.data.gosai import batch_dna_detokenize
from svdd.models.convgru import ConvGRUValueModel
from svdd.train import diffusion as train_diff
from svdd.train import value as train_val

cfg = rna_config()
cfg.optim.warmup_steps = 50
cfg.optim.lr = 1e-3
cfg.loader.batch_size = 16
L = cfg.model.length

# ---------------------------------------------------------------- stage 1
ds = GosaiDataset('train', length=L)
val_ds = GosaiDataset('val', length=L)
it = iter(FaultTolerantIterator(ds, cfg.loader.batch_size, seed=0))
model = Diffusion(cfg, rng=jax.random.key(0))
trainer = train_diff.Trainer(model, cfg)
state = trainer.init_or_restore(jax.random.key(1))
phase('diffusion trainer ready')

losses = []
for i in range(1200):
  batch = {k: jnp.asarray(v) for k, v in next(it).items()}
  state, loss = trainer.train_step(state, batch)
  if i % 250 == 0:
    losses.append(float(loss))
    phase(f'diffusion step {i} loss {float(loss):.4f}')
RESULTS['diffusion_loss_first'] = losses[0]
RESULTS['diffusion_loss_last'] = float(loss)
# use EMA params for everything downstream (reference eval semantics)
from svdd.models import ema as ema_lib
model.variables = {'params': ema_lib.params(state.ema), **state.extras}
phase(f'diffusion pretrained: loss {losses[0]:.3f} -> {float(loss):.3f}')

# sample quality: 3-mer pearson vs training data
samp = model.sampler(256)(jax.random.key(7)).samples
gen_seqs = batch_dna_detokenize(np.asarray(samp))
data_seqs = batch_dna_detokenize(ds.seqs[:1024])
RESULTS['kmer_pearson'] = kmer_pearson(gen_seqs, data_seqs)
phase(f"3-mer pearson generated vs data: {RESULTS['kmer_pearson']:.4f}")

# ---------------------------------------------------------------- stage 2
oracle_module = ConvGRUValueModel(n_tasks=1)
ovars = jax.jit(oracle_module.init)(jax.random.key(2),
                                    jnp.zeros((1, L, 4)))
oparams = ovars.pop('params') if isinstance(ovars, dict) else None
oextras = ovars
opt = optax.adamw(1e-3)
opt_state = opt.init(oparams)


@jax.jit
def oracle_step(params, extras, opt_state, seqs, labels, key):
  def loss_fn(p):
    preds, upd = oracle_module.apply(
        {'params': p, **extras}, jax.nn.one_hot(seqs, 4), train=True,
        mutable=['batch_stats'], rngs={'dropout': key})
    return jnp.mean((preds - labels[:, 0]) ** 2), upd
  (loss, upd), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
  u, opt_state = opt.update(g, opt_state, params)
  return optax.apply_updates(params, u), {**extras, **upd}, \
      opt_state, loss


oit = iter(FaultTolerantIterator(ds, 16, seed=3))
key = jax.random.key(4)
for i in range(800):
  b = next(oit)
  key, sub = jax.random.split(key)
  oparams, oextras, opt_state, oloss = oracle_step(
      oparams, oextras, opt_state, jnp.asarray(b['seqs']),
      jnp.asarray(b['clss']), sub)
oracle_vars = {'params': oparams, **oextras}
preds = np.asarray(oracle_module.apply(
    oracle_vars, jax.nn.one_hot(jnp.asarray(val_ds.seqs[:512]), 4)))
r = np.corrcoef(preds, val_ds.clss[:512, 0])[0, 1]
RESULTS['oracle_val_pearson'] = float(r)
phase(f'oracle trained: MSE {float(oloss):.4f}, val pearson {r:.3f}')


def oracle_apply(variables, onehot):
  return oracle_module.apply(variables, onehot)


oracle_pair = (oracle_apply, oracle_vars)

# ---------------------------------------------------------------- stage 3
vf = value_lib.ValueFunction.create('rna', L, jax.random.key(5))
tcfg = train_val.ValueTrainerConfig(batch_size=16, learning_rate=1e-3)
vtrainer = train_val.ValueTrainer(
    model, vf, lambda oh: oracle_module.apply(oracle_vars, oh), tcfg)
vstate = vtrainer.init_state(jax.random.key(6))
vstate, vloss0 = vtrainer._train_step(vstate, None)
phase(f'value trainer compiled, first MSE {float(vloss0):.4f}')
for i in range(300):
  vstate, vloss = vtrainer._train_step(vstate, None)
RESULTS['value_mse_first'] = float(vloss0)
RESULTS['value_mse_last'] = float(vloss)
phase(f'value net trained: MSE {float(vloss0):.4f} -> {float(vloss):.4f}')
value_vars = {'params': vstate.params, **vstate.extras}


def value_apply(variables, tokens):
  return vf.module.apply(variables, mdlm.transform_samples(tokens))


# ---------------------------------------------------------------- stage 4
B = 256
mc = run_decode(model, oracle_pair, algo='svdd_mc',
                value_fn=(value_apply, value_vars),
                gen_batch_num=1, batch_size=B, sample_M=10, seed=44)
phase('SVDD-MC decode done')
mc.save_npz('log/demo-rna-MRL.npz')

pm = run_decode(model, oracle_pair, algo='svdd_pm',
                gen_batch_num=1, batch_size=B, sample_M=10, seed=44,
                skip_best_of_n=True)
phase('SVDD-PM decode done')
pm.save_npz('log/demo-rna-MRL_tw.npz')

report = quantile_report({
    'baseline (pretrained)': mc.baseline_preds,
    'SVDD-MC': mc.reward_preds,
    'SVDD-PM': pm.reward_preds,
    'best-of-N': mc.top_k,
})
RESULTS['report'] = report
for name, row in report.items():
  phase(f"{name:22s} q50={row['q50']:.3f} q80={row['q80']:.3f} "
        f"q90={row['q90']:.3f} (n={row['n']})")

with open('log/demo_pipeline.json', 'w') as f:
  json.dump(RESULTS, f, indent=2)
phase('wrote log/demo_pipeline.json')
