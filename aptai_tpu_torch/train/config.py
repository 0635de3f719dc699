"""Experiment configuration: dataclasses and the CLI, with the JAX
package's fields, defaults and flag names (``aptai_tpu/train/config.py``),
so its launch scripts translate 1:1.

Fields that mean something only to the JAX package, or to parts this
package does not implement yet, are checked by :meth:`TrainConfig.finalize`
as ``models/configs.py`` checks its unported fields:

* ``platform``: ``"auto"`` runs on ``cuda``, ``"cpu"`` on the CPU; any other
  value raises (:func:`run_device`);
* ``coordinator_address``, ``num_processes``, ``process_id``: a
  multi-process run, one process per device (``parallel/multihost.py``):
  :meth:`TrainConfig.finalize` joins the process group, filling the last
  two from the launcher's environment when they are unset;
* ``mesh_data``, ``mesh_model``, ``fsdp``: the ``(data, model)`` mesh of
  those processes (``parallel/mesh.py``; ``train/harness.py::
  make_engine``): ``mesh_model`` processes split each encoder layer
  (tensor parallelism, and sequence parallelism under the backbone's
  ``activation_partition``), and the data axis splits the batch, under
  FSDP the parameters too; a process count that ``mesh_model`` does not
  divide raises the JAX package's ``ValueError`` at ``finalize``;
* ``rng_impl``: ``"rbg"`` and ``"threefry"`` are both accepted and mean the
  same here: torch has one Philox generator per device, which the train
  step seeds per step (``train/harness.py``);
* ``debug_nans``: ``torch.autograd`` anomaly detection around ``fit``
  (``train/loop.py``), which names the backward op that made a NaN.

``finalize`` touches no process-wide state, except that a
``coordinator_address`` joins this process to the run's process group.
"""

from __future__ import annotations

import argparse
import dataclasses
from datetime import datetime
from pathlib import Path
from typing import Optional

import torch

PLATFORMS = ("auto", "cpu")
RNG_IMPLS = ("rbg", "threefry")


@dataclasses.dataclass
class TrainConfig:
    """Shared trainer options (flag names match the reference)."""

    exp_dir: Optional[str] = None
    cache_dir: str = ".cache"
    logging: bool = False
    laptop: bool = False
    prefix: str = ""

    num_epochs: int = 160
    num_warmup_epochs: int = 0
    num_static_epochs: int = 0
    batch_size: int = 4
    # 0 → evaluate at the training batch size through the bucketed loader
    eval_batch_size: int = 0
    learning_rate: float = 5e-4
    lr_decay: float = 0.96
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 0.0
    save_all_epochs: bool = False
    # split each batch into k equal microbatches, one optimizer update
    grad_accum: int = 1
    # last-checkpoint cadence (epochs); improving epochs always write;
    # 0 → checkpoint only at the end
    ckpt_every: int = 1
    # SIGTERM/SIGUSR1 (and a first Ctrl-C) finish the in-flight step, write
    # a resumable last checkpoint and exit 0 (train/loop.py)
    graceful_preemption: bool = True
    target_metric: str = "mean_val_per"
    target_metric_bigger_better: bool = False
    seed: int = 0
    detect_anomaly: bool = False  # per-step NaN/Inf guard (forces a sync)
    debug_nans: bool = False      # autograd anomaly detection in fit

    # model
    num_hidden_layers: int = 24
    final_dropout: float = 0.0
    ten_ms: bool = False
    remat_policy: str = "none"    # "none" | "full" | "dots" (configs.py)
    huggingface_model_id: str = "facebook/wav2vec2-large-xlsr-53"
    pretrained_checkpoint: Optional[str] = None
    freeze_feature_extractor: bool = False
    # compute dtype (parameters and Adam state stay float32): "auto" =
    # bfloat16 on the card, float32 on the CPU (train/builders.py)
    dtype: str = "auto"

    # parallelism: the data axis over the run's processes (see the module
    # docstring); fsdp shards parameters and Adam state over it
    mesh_data: int = -1
    mesh_model: int = 1
    fsdp: bool = False
    platform: str = "auto"
    rng_impl: str = "rbg"
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    # derived
    date_time: str = ""
    exp_name: str = ""
    train_from_ckpt: bool = False

    def finalize(self, task: str) -> "TrainConfig":
        _check_fields(self)
        if self.coordinator_address:
            from aptai_tpu_torch.parallel.multihost import (
                init_distributed, process_env_defaults)

            env = process_env_defaults()
            if self.num_processes <= 0:
                self.num_processes = env.get("num_processes", 0)
            if self.process_id < 0:
                self.process_id = env.get("process_id", -1)
            init_distributed(self.coordinator_address, self.num_processes,
                             self.process_id,
                             device="cpu" if self.platform == "cpu"
                             else "cuda")
        from aptai_tpu_torch.parallel.multihost import process_count

        n = process_count()
        if n % self.mesh_model:
            raise ValueError(
                f"{n} devices not divisible by model={self.mesh_model}")
        self.date_time = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
        if self.laptop:  # debug mode truncation (reference :186-189)
            self.num_epochs = 1
            self.num_warmup_epochs = 1
            self.num_static_epochs = 1
        if self.exp_dir is None:
            self.exp_dir = str(
                Path("experiments") / task
                / f"{self.date_time}_{self.exp_name or self.prefix}"
            )
            self.train_from_ckpt = False
        else:
            self.train_from_ckpt = Path(self.exp_dir).exists()
        return self


def _check_fields(cfg: TrainConfig) -> None:
    if cfg.platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS} ('auto' runs "
                         f"on cuda), got {cfg.platform!r}")
    if cfg.rng_impl not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got "
                         f"{cfg.rng_impl!r}")
    if cfg.mesh_model < 1:
        raise ValueError(f"mesh_model must be >= 1, got {cfg.mesh_model}")


def run_device(cfg) -> torch.device:
    """The device a run's config names: ``cuda`` for ``platform="auto"``
    (raising without a card: nothing falls back), the CPU for ``"cpu"``."""
    from aptai_tpu_torch.infer.api import resolve_device

    if cfg.platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{cfg.platform!r}")
    return resolve_device("cpu" if cfg.platform == "cpu" else "cuda")


@dataclasses.dataclass
class PRConfig(TrainConfig):
    """Phoneme-recognizer trainer (reference train_phoneme_recognizer.py)."""

    cp_csv_path: str = "data/CommonPhone/commonphone.csv"
    hprc_csv_path: str = "data/HPRC_prep/hprc.csv"
    cropping: bool = False
    samples_per_epoch: int = 2000
    # per-epoch validation decode: "beam_device" (the batched beam on the
    # card, decode/device.py), "beam" (the host beam, C++ first) or
    # "greedy"; the final test always decodes with the host beam
    val_decode: str = "beam_device"
    # train from cached frozen conv-FE features (train/fe_cache.py); only
    # with --freeze_feature_extractor and cropping off
    cache_frozen_fe: bool = True


@dataclasses.dataclass
class APTAIConfig(TrainConfig):
    """APTAI trainer (reference train_aptai.py)."""

    hprc_csv_path: str = "data/HPRC_prep/hprc.csv"
    vocab_path: str = "vocab.json"
    train_val_rate: str = "both"
    target_metric: str = "val_mean_rmse"
    tv_drop: float = 0.1
    phn_drop: float = 0.1
    num_epochs: int = 20
    learning_rate: float = 1e-5
    batch_size: int = 5
    # run the frozen conv feature extractor once per utterance per fold and
    # train from its cached output (train/fe_cache.py)
    cache_frozen_fe: bool = True


@dataclasses.dataclass
class ForceAPTAIConfig(TrainConfig):
    """FORCE-APTAI trainer (reference train_force_aptai.py)."""

    hprc_csv_path: str = "data/HPRC_prep/hprc.csv"
    pr_model_path: str = "experiments/phoneme_recognizer/best"
    vocab_path: str = "vocab.json"
    train_val_rate: str = "N"
    target_metric: str = "val_mean_rmse"
    num_epochs: int = 60
    learning_rate: float = 1e-5
    batch_size: int = 5
    # in-step CTC decode: "greedy", "beam_device" (the batched beam on the
    # tower's device) or "beam_host" (the host beam between the tower and
    # the head)
    decode_method: str = "greedy"
    # blank-collapse guard: val_ctc_seq_per ≥ threshold for `patience`
    # epochs warns; --collapse_fallback resumes the fold with beam_host
    collapse_per_threshold: float = 0.95
    collapse_patience: int = 3
    collapse_fallback: bool = False
    # alignment knobs (defaults reference-exact; models/force_aptai.py)
    blank_logprob: float = -1.0
    off_diag_prior: bool = False
    prior_g: float = 0.2
    energy_temperature: float = 1.0
    aux_frame_ce: float = 0.0
    frame_hidden_layer: int = -1
    # run the frozen tower (and the decode) once per utterance and train the
    # head from the cached encodings (train/frozen_cache.py)
    cache_frozen_encodings: bool = True


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in ("date_time", "exp_name", "train_from_ckpt"):
            continue
        arg = f"--{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(arg, action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.type in ("Optional[str]", "typing.Optional[str]"):
            parser.add_argument(arg, type=str, default=f.default)
        else:
            typ = {int: int, float: float, str: str}.get(
                {"int": int, "float": float, "str": str}.get(f.type, f.type),
                str,
            )
            parser.add_argument(arg, type=typ, default=f.default)


def parse_config(cls, task: str, argv=None):
    parser = argparse.ArgumentParser(
        description=f"aptai_tpu_torch {task} trainer")
    _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    cfg = cls(**{f.name: getattr(ns, f.name)
                 for f in dataclasses.fields(cls)
                 if hasattr(ns, f.name)})
    return cfg.finalize(task)
