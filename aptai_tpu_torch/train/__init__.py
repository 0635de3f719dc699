from aptai_tpu_torch.train.harness import TrainStep, torch_adam
from aptai_tpu_torch.train.schedule import epoch_learning_rate, lr_lambda

__all__ = ["TrainStep", "epoch_learning_rate", "lr_lambda", "torch_adam"]
