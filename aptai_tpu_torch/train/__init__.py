from aptai_tpu_torch.train.harness import TrainStep, torch_adam
from aptai_tpu_torch.train.schedule import epoch_learning_rate, lr_lambda
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn
from aptai_tpu_torch.train.train_pr import pr_loss_fn

__all__ = ["TrainStep", "aptai_loss_fn", "epoch_learning_rate", "lr_lambda",
           "pr_loss_fn", "torch_adam"]
