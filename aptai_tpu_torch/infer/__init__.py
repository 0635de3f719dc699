from aptai_tpu_torch.infer.api import (APTAIPredictor, ForceAPTAIPredictor,
                                      W2V2PRPredictor, fetch_outputs)
from aptai_tpu_torch.infer.loader import load_model, load_predictor
from aptai_tpu_torch.infer.serve import ServingApp, build_app, make_server
from aptai_tpu_torch.infer.server import MicroBatcher
from aptai_tpu_torch.infer.streaming import (StreamingAPTAI,
                                            StreamingForceAPTAI,
                                            StreamingPredictor,
                                            StreamingW2V2PR)

__all__ = ["APTAIPredictor", "ForceAPTAIPredictor", "MicroBatcher",
           "ServingApp", "StreamingAPTAI", "StreamingForceAPTAI",
           "StreamingPredictor", "StreamingW2V2PR", "W2V2PRPredictor",
           "build_app", "fetch_outputs", "load_model", "load_predictor",
           "make_server"]
