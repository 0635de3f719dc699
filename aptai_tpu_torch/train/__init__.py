from aptai_tpu_torch.train.fe_cache import FECachedLoader, collate_fe
from aptai_tpu_torch.train.frozen_cache import (EncodedItemsLoader,
                                                FrozenEncodedCorpus,
                                                FrozenEncodedLoader,
                                                collate_encoded, encode_items)
from aptai_tpu_torch.train.harness import TrainStep, torch_adam
from aptai_tpu_torch.train.schedule import epoch_learning_rate, lr_lambda
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn
from aptai_tpu_torch.train.train_force_aptai import force_loss_fn
from aptai_tpu_torch.train.train_pr import pr_loss_fn

__all__ = ["EncodedItemsLoader", "FECachedLoader", "FrozenEncodedCorpus",
           "FrozenEncodedLoader", "TrainStep", "aptai_loss_fn",
           "collate_encoded", "collate_fe", "encode_items",
           "epoch_learning_rate", "force_loss_fn", "lr_lambda", "pr_loss_fn",
           "torch_adam"]
