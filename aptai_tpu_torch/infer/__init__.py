from aptai_tpu_torch.infer.api import (APTAIPredictor, ForceAPTAIPredictor,
                                      W2V2PRPredictor, fetch_outputs)
from aptai_tpu_torch.infer.server import MicroBatcher

__all__ = ["APTAIPredictor", "ForceAPTAIPredictor", "MicroBatcher",
           "W2V2PRPredictor", "fetch_outputs"]
