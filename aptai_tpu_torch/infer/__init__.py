from aptai_tpu_torch.infer.api import APTAIPredictor, fetch_outputs
from aptai_tpu_torch.infer.server import MicroBatcher

__all__ = ["APTAIPredictor", "MicroBatcher", "fetch_outputs"]
