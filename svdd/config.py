"""Typed configuration system.

Replaces the reference's three Hydra config trees (configs_gosai/,
configs_gosai_rna/, configs/ — see main_gosai.py:19-29 for the custom
resolvers) with plain dataclasses + YAML overlays. Presets ``dna_config``
and ``rna_config`` reproduce the reference's default experiment configs
(configs_gosai/config_gosai.yaml and configs_gosai_rna/, which differ
only in model.length=50, the eval interval, and the wandb project).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _update(obj: Any, overrides: Dict[str, Any]) -> None:
  for k, v in overrides.items():
    if not hasattr(obj, k):
      raise KeyError(f'unknown config key {k!r} on {type(obj).__name__}')
    cur = getattr(obj, k)
    if dataclasses.is_dataclass(cur) and isinstance(v, dict):
      _update(cur, v)
    else:
      setattr(obj, k, v)


@dataclass
class NoiseConfig:
  type: str = 'loglinear'   # loglinear/cosine/cosinesqr/linear/geometric
  sigma_min: float = 1e-4
  sigma_max: float = 20.0
  eps: float = 1e-3


@dataclass
class ModelConfig:
  # dnaconv (reference configs_gosai/model/dnaconv.yaml)
  name: str = 'dnaconv'
  length: int = 200
  hidden_dim: int = 128
  num_cnn_stacks: int = 4
  dropout: float = 0.0
  clean_data: bool = False
  cls_free_guidance: bool = False
  # dit (reference configs_gosai/model/small.yaml)
  hidden_size: int = 768
  cond_dim: int = 128
  n_blocks: int = 12
  n_heads: int = 12
  scale_by_sigma: bool = True
  # dimamba
  n_layer: int = 4
  d_model: int = 256


@dataclass
class LoaderConfig:
  global_batch_size: int = 512
  eval_global_batch_size: int = 512
  batch_size: int = 512        # per-process; derived at mesh setup
  eval_batch_size: int = 512


@dataclass
class SamplingConfig:
  predictor: str = 'ddpm'      # ddpm / ddpm_cache / analytic
  steps: int = 128
  noise_removal: bool = True
  num_sample_batches: int = 2
  semi_ar: bool = False
  stride_length: int = 1
  num_strides: int = 1


@dataclass
class TrainingConfig:
  ema: float = 0.9999
  antithetic_sampling: bool = True
  importance_sampling: bool = False
  sampling_eps: float = 1e-3
  change_of_variables: bool = False
  # Gradient accumulation (reference: Lightning accumulate_grad_batches
  # derived from the global batch, configs_gosai/config_gosai.yaml:75).
  # The per-step batch is split into this many microbatches; grads are
  # averaged before ONE optimizer update, bounding activation memory
  # at large global batches.
  accum_steps: int = 1


@dataclass
class OptimConfig:
  weight_decay: float = 0.0
  lr: float = 3e-4
  beta1: float = 0.9
  beta2: float = 0.999
  eps: float = 1e-8
  grad_clip: float = 1.0
  warmup_steps: int = 2500
  max_steps: int = 131_500
  lr_schedule: str = 'constant_warmup'   # constant_warmup / cosine_decay_warmup
  lr_min: float = 1e-6


@dataclass
class EvalConfig:
  checkpoint_path: str = ''
  disable_ema: bool = False
  generate_samples: bool = True
  subset_size: int = 5000
  val_check_interval: int = 1000


@dataclass
class CheckpointingConfig:
  save_dir: str = './checkpoints'
  resume_from_ckpt: bool = True
  every_n_steps: int = 1000


@dataclass
class ParallelConfig:
  # Mesh axes; data axis reproduces DDP / DataParallel / distributed-
  # sampler semantics, model axis adds TP (reference has none, §2.2).
  data_axis: int = -1          # -1: all devices
  model_axis: int = 1
  fsdp: bool = False           # shard params/opt-state over data axis
  fsdp_min_size: int = 2 ** 14  # replicate params smaller than this
  precision: str = 'bf16'      # compute dtype for model forwards
  # pipeline parallelism for the DiT text-MDLM training loop (beyond
  # the data-parallel-only reference, SURVEY §2.2): split the n_blocks
  # DDiTBlock stack into `pipeline_stages` GPipe stages over a 'pipe'
  # mesh axis (parallel/pipeline.py). 0 microbatches -> 4x stages.
  pipeline_stages: int = 1
  pipeline_microbatches: int = 0
  pipeline_virtual: int = 1    # >1: interleaved (Megatron) schedule


@dataclass
class Config:
  mode: str = 'train'          # train / ppl_eval / sample_eval
  diffusion: str = 'absorbing_state'
  backbone: str = 'cnn'        # cnn / dit / dimamba / ar
  parameterization: str = 'subs'   # subs / d3pm / sedd
  time_conditioning: bool = False
  T: int = 0                   # 0 = continuous time
  subs_masking: bool = False
  seed: int = 1
  task: str = 'dna'            # dna / rna / rna_saluki / text
  # alphabet size WITHOUT the mask token; 4 = {A,C,G,T} for the bio
  # tasks (diffusion_gosai.py:85-95); text MDLM sets the tokenizer's
  # vocab size here (legacy diffusion.py pipeline)
  alphabet_size: int = 4

  noise: NoiseConfig = field(default_factory=NoiseConfig)
  model: ModelConfig = field(default_factory=ModelConfig)
  loader: LoaderConfig = field(default_factory=LoaderConfig)
  sampling: SamplingConfig = field(default_factory=SamplingConfig)
  training: TrainingConfig = field(default_factory=TrainingConfig)
  optim: OptimConfig = field(default_factory=OptimConfig)
  eval: EvalConfig = field(default_factory=EvalConfig)
  checkpointing: CheckpointingConfig = field(
      default_factory=CheckpointingConfig)
  parallel: ParallelConfig = field(default_factory=ParallelConfig)

  @property
  def vocab_size(self) -> int:
    return self.alphabet_size + 1   # + MASK (diffusion_gosai.py:94-95)

  @property
  def mask_index(self) -> int:
    return self.alphabet_size

  def override(self, **overrides: Any) -> 'Config':
    cfg = dataclasses.replace(self)
    # deep-copy nested dataclasses so replace() doesn't share them
    for f in dataclasses.fields(cfg):
      v = getattr(cfg, f.name)
      if dataclasses.is_dataclass(v):
        setattr(cfg, f.name, dataclasses.replace(v))
    _update(cfg, overrides)
    return cfg

  def to_dict(self) -> Dict[str, Any]:
    return dataclasses.asdict(self)

  @staticmethod
  def from_dict(d: Dict[str, Any]) -> 'Config':
    cfg = Config()
    _update(cfg, d)
    return cfg

  @staticmethod
  def from_yaml(path: str) -> 'Config':
    import yaml
    with open(path) as f:
      return Config.from_dict(yaml.safe_load(f) or {})


def dna_config(**overrides: Any) -> Config:
  """DNA enhancer task (Gosai, L=200, HepG2 reward) — the reference's
  configs_gosai/config_gosai.yaml defaults."""
  cfg = Config(task='dna')
  return cfg.override(**overrides) if overrides else cfg


def rna_config(**overrides: Any) -> Config:
  """RNA 5'UTR task (L=50, MRL reward) — configs_gosai_rna/ differs from
  DNA only in model.length (configs_gosai_rna/model/dnaconv.yaml:5)."""
  cfg = Config(task='rna')
  cfg.model.length = 50
  return cfg.override(**overrides) if overrides else cfg


def tiny_test_config(task: str = 'rna', **overrides: Any) -> Config:
  """Small config for CPU unit tests."""
  cfg = rna_config() if task == 'rna' else dna_config()
  cfg.task = task
  cfg.model.length = 16 if task == 'rna' else 24
  cfg.model.hidden_dim = 32
  cfg.model.num_cnn_stacks = 1
  cfg.model.hidden_size = 32
  cfg.model.cond_dim = 16
  cfg.model.n_blocks = 2
  cfg.model.n_heads = 2
  cfg.sampling.steps = 8
  cfg.loader.global_batch_size = 8
  cfg.loader.eval_global_batch_size = 8
  cfg.loader.batch_size = 8
  cfg.loader.eval_batch_size = 8
  cfg.parallel.precision = 'fp32'
  return cfg.override(**overrides) if overrides else cfg
