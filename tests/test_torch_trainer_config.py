"""aptai_tpu_torch's trainer configs against the JAX package's, on the CPU:
``parse_config`` of each config class on the same argv gives the same
field values in both packages; the model axis, a multi-process launch
without its ranks and unknown platforms raise; ``run_device`` never falls back to the CPU; the run
logger keeps its JSONL without wandb.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from aptai_tpu.train import config as jconfig
from aptai_tpu_torch.train import builders
from aptai_tpu_torch.train import config as tconfig


# -- config -------------------------------------------------------------------

ARGV = {
    "PRConfig": ["--laptop", "--batch_size", "3", "--val_decode", "greedy",
                 "--no-cache_frozen_fe", "--learning_rate", "2e-4"],
    "APTAIConfig": ["--train_val_rate", "N", "--tv_drop", "0.2",
                    "--ckpt_every", "0", "--save_all_epochs"],
    "ForceAPTAIConfig": ["--decode_method", "beam_device",
                         "--collapse_fallback", "--prior_g", "0.3",
                         "--no-cache_frozen_encodings", "--grad_accum", "2"],
}


@pytest.mark.parametrize("name", list(ARGV))
def test_parse_config_matches_jax(tmp_path, name):
    argv = ARGV[name] + ["--exp_dir", str(tmp_path / "run"), "--rng_impl",
                         "threefry", "--platform", "cpu", "--mesh_data", "1"]
    got = tconfig.parse_config(getattr(tconfig, name), "task", argv)
    want = jconfig.parse_config(getattr(jconfig, name), "task", argv)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("date_time") and w.pop("date_time")
    assert g == w
    # the defaults too, with exp_dir derived from the task
    got = dataclasses.asdict(getattr(tconfig, name)())
    assert got == dataclasses.asdict(getattr(jconfig, name)())


LAUNCH_ENV = ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "RANK", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT")


@pytest.mark.parametrize("fields,error,match", [
    ({"mesh_model": 2}, ValueError, "not divisible by model=2"),
    ({"coordinator_address": "127.0.0.1:1"}, ValueError, "num_processes"),
    ({"coordinator_address": "auto"}, ValueError, "environment"),
    ({"coordinator_address": "127.0.0.1:1", "num_processes": 2,
      "process_id": 2}, ValueError, "not below"),
    ({"platform": "tpu"}, ValueError, "platform"),
    ({"rng_impl": "philox"}, ValueError, "rng_impl")])
def test_config_fields_that_raise(tmp_path, monkeypatch, fields, error,
                                  match):
    """The fields the port refuses: a model axis the processes do not
    divide (one process here), a
    multi-process launch without its ranks (no launcher environment), an
    unknown platform or PRNG. The data axis's fields finalize: one process
    has no mesh, so ``fsdp`` changes nothing there."""
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    cfg = tconfig.TrainConfig(exp_dir=str(tmp_path), **fields)
    with pytest.raises(error, match=match):
        cfg.finalize("task")
    for impl in ("rbg", "threefry"):  # both mean the same here
        assert tconfig.TrainConfig(rng_impl=impl, platform="cpu").finalize(
            "task").rng_impl == impl
    done = tconfig.TrainConfig(exp_dir=str(tmp_path), platform="cpu",
                               mesh_data=1, fsdp=True).finalize("task")
    assert done.fsdp and not torch.distributed.is_initialized()


def test_run_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tconfig.run_device(tconfig.TrainConfig(platform="cpu")).type \
        == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.run_device(tconfig.TrainConfig())
    assert builders.resolve_dtype("auto", "cuda") == "bfloat16"
    assert builders.resolve_dtype("auto", "cpu") == "float32"
    assert builders.resolve_dtype("float32", "cuda") == "float32"


def test_run_logger_without_wandb_keeps_jsonl(tmp_path, monkeypatch, capsys):
    import sys

    from aptai_tpu_torch.utils.logging import RunLogger, init_logger

    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    cfg = tconfig.APTAIConfig(exp_dir=str(tmp_path), logging=True,
                              platform="cpu").finalize("APTAI")
    logger = init_logger(cfg, "APTAI")
    assert "JSONL only" in capsys.readouterr().out
    logger.log({"loss": np.float32(1.5), "epoch": 0}, step=3)
    logger.finish()
    event = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert event["step"] == 3 and event["loss"] == 1.5 and "ts" in event
    assert RunLogger(tmp_path, "x")._wandb is None
