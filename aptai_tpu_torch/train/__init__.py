from aptai_tpu_torch.train.builders import (build_aptai_model,
                                            build_force_model,
                                            build_pr_model,
                                            make_backbone_config,
                                            resolve_dtype)
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               msgpack_restore,
                                               msgpack_serialize)
from aptai_tpu_torch.train.config import (APTAIConfig, ForceAPTAIConfig,
                                          PRConfig, TrainConfig,
                                          parse_config)
from aptai_tpu_torch.train.fe_cache import FECachedLoader, collate_fe
from aptai_tpu_torch.train.frozen_cache import (EncodedItemsLoader,
                                                FrozenEncodedCorpus,
                                                FrozenEncodedLoader,
                                                collate_encoded, encode_items)
from aptai_tpu_torch.train.harness import TrainStep, make_engine, torch_adam
from aptai_tpu_torch.train.loop import Preempted, fit
from aptai_tpu_torch.train.schedule import epoch_learning_rate, lr_lambda

# the loss adapters (and the pretraining config) live in the trainer
# modules, which are imported when first asked for: ``python -m
# aptai_tpu_torch.train.<trainer>`` then runs a module the package has not
# imported already
_FROM_TRAINERS = {"aptai_loss_fn": "train_aptai",
                  "force_loss_fn": "train_force_aptai",
                  "pr_loss_fn": "train_pr",
                  "pretrain_loss_fn": "pretrain",
                  "PretrainConfig": "pretrain"}


def __getattr__(name):
    if name in _FROM_TRAINERS:
        import importlib

        module = importlib.import_module(
            f"aptai_tpu_torch.train.{_FROM_TRAINERS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["APTAIConfig", "CheckpointManager", "EncodedItemsLoader",
           "FECachedLoader", "ForceAPTAIConfig", "FrozenEncodedCorpus",
           "FrozenEncodedLoader", "PRConfig", "Preempted", "TrainConfig",
           "TrainStep", "aptai_loss_fn", "build_aptai_model",
           "build_force_model", "build_pr_model", "collate_encoded",
           "collate_fe", "encode_items", "epoch_learning_rate", "fit",
           "force_loss_fn", "lr_lambda", "make_backbone_config",
           "make_engine", "msgpack_restore", "msgpack_serialize",
           "parse_config", "pr_loss_fn", "resolve_dtype", "torch_adam"]
