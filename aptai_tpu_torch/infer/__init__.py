"""Inference: the predictors, the micro-batcher, the streamers, the HTTP
serving front end and the serving bundles.

Names load on first use, so that ``aptai_tpu_torch.infer.export`` (a
serving bundle's loader) imports no model code.
"""

import importlib

_NAMES = {
    "APTAIPredictor": "api", "ForceAPTAIPredictor": "api",
    "W2V2PRPredictor": "api", "fetch_outputs": "transfer",
    "load_model": "loader", "load_predictor": "loader",
    "ServingApp": "serve", "build_app": "serve", "make_server": "serve",
    "MicroBatcher": "server", "StreamingAPTAI": "streaming",
    "StreamingForceAPTAI": "streaming", "StreamingPredictor": "streaming",
    "StreamingW2V2PR": "streaming", "ServingBundle": "export",
    "load_serving_bundle": "export", "save_serving_bundle": "export",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_NAMES))
