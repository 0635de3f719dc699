"""Run logging: a JSONL metric stream, mirrored to wandb when asked.

Every metric event is appended to ``<exp_dir>/metrics.jsonl``
(machine-readable, survives offline runs); with ``use_wandb`` the events
also go to wandb, which is imported only then. Without the wandb package
the run keeps the JSONL stream alone and says so. The wandb run id is kept
in ``<exp_dir>/wandbRunId`` as text, so a resumed run continues it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class RunLogger:
    def __init__(self, exp_dir, project: str, run_name: str = "",
                 use_wandb: bool = False, resume: bool = False,
                 config: Optional[Dict] = None):
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.exp_dir / "metrics.jsonl"
        self._wandb = None
        if use_wandb:
            self._wandb = _init_wandb(self.exp_dir, project, run_name,
                                      resume, config or {})

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        event = {"ts": time.time(), **({"step": step} if step is not None
                                       else {}),
                 **{k: _jsonable(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v) if hasattr(v, "__float__") else str(v)


def _init_wandb(exp_dir: Path, project: str, run_name: str, resume: bool,
                config: Dict):
    """A new wandb run, or the one whose id ``exp_dir`` keeps when
    ``resume``; None (JSONL only) without the wandb package."""
    try:
        import wandb
    except ImportError:
        print("logging: wandb not available, JSONL only")
        return None
    id_file = exp_dir / "wandbRunId"
    if resume and id_file.exists():
        run_id = id_file.read_text().strip()
        return wandb.init(id=run_id, resume="allow")
    run_id = wandb.util.generate_id()
    id_file.write_text(run_id)
    return wandb.init(id=run_id, project=project, name=run_name,
                      dir=str(exp_dir), resume="allow", config=config)


def init_logger(cfg, project_name: str) -> RunLogger:
    """The run's logger from its config: ``exp_dir``, ``exp_name``,
    ``logging`` (wandb on or off), ``train_from_ckpt`` (resume)."""
    return RunLogger(
        cfg.exp_dir, project_name, run_name=getattr(cfg, "exp_name", ""),
        use_wandb=getattr(cfg, "logging", False),
        resume=getattr(cfg, "train_from_ckpt", False),
        config={
            "learning_rate": getattr(cfg, "learning_rate", None),
            "epochs": getattr(cfg, "num_epochs", None),
            "batch_size": getattr(cfg, "batch_size", None),
        },
    )
