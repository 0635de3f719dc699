"""The 3-phase epoch learning-rate schedule of the APTAI trainers:

  * warmup: linear ramp to 10× the base LR over ``warmup_epochs``;
  * static: hold 10× for ``static_epochs``;
  * decay: 10 · decay^(epoch − warmup − static).
"""

from __future__ import annotations


def lr_lambda(epoch: int, warmup_epochs: int, static_epochs: int,
              lr_decay: float) -> float:
    if warmup_epochs and epoch < warmup_epochs:
        return 10.0 * (epoch + 1) / warmup_epochs
    if epoch < warmup_epochs + static_epochs:
        return 10.0
    return 10.0 * lr_decay ** (epoch - (warmup_epochs + static_epochs))


def epoch_learning_rate(base_lr: float, epoch: int, warmup_epochs: int,
                        static_epochs: int, lr_decay: float) -> float:
    """LambdaLR semantics: base LR × multiplier(epoch)."""
    return base_lr * lr_lambda(epoch, warmup_epochs, static_epochs, lr_decay)
