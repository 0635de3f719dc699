"""aptai_tpu_torch's ``CheckpointManager`` against the JAX package's:

* on the same metric sequences (smaller and bigger better, ties,
  ``save_all_epochs``, ``save_last=False`` epochs): the same improvement
  flags, best watermark, file names, ``train_meta.json`` and
  ``model_cfg.json`` key for key, ``params.msgpack`` and
  ``opt_state.msgpack`` byte for byte, and equal tensors through both
  packages' readers;
* ``save_interrupt`` and ``restore_last`` (a new manager over the same
  directory);
* an older run's ``params.pt`` / ``opt_state.pt`` still restore, and a
  write into that directory replaces them.
"""

import json

import jax
import numpy as np
import pytest
import torch

from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu_torch.train import checkpoints as tckpt

from _torch_port import one_torch_thread


V = 11
VOCAB = {f"p{i}": i for i in range(V)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


# -- CheckpointManager --------------------------------------------------------

# (bigger is better, save_all_epochs, target values, save_last per epoch)
CASES = {
    "smaller_better": (False, False, [0.5, 0.7, 0.4, 0.6], None),
    "bigger_better": (True, False, [0.1, 0.05, 0.2, 0.3], None),
    "ties": (False, False, [0.5, 0.5, 0.7, 0.5], None),
    "save_all_epochs": (False, True, [0.5, 0.7, 0.4, 0.6], None),
    "save_last_false": (False, False, [0.5, 0.7, 0.4, 0.8],
                        [False, False, False, True]),
}


def _files(root, suffix):
    return sorted(str(p.relative_to(root)).replace(suffix, "")
                  for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_manager_matches_jax(tmp_path, case):
    bigger, save_all, values, save_last = CASES[case]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jm = jckpt.CheckpointManager(jdir, "m", bigger_is_better=bigger,
                                 save_all_epochs=save_all)
    tm = tckpt.CheckpointManager(tdir, "m", bigger_is_better=bigger,
                                 save_all_epochs=save_all)
    model_cfg = {"kind": "aptai", "vocab": VOCAB}
    for epoch, value in enumerate(values):
        w = np.full((3, 2), epoch, np.float32)
        mu = np.full((3,), 10.0 + epoch, np.float32)
        metrics = {"m": value, "other": 2.0 * epoch}
        last = True if save_last is None else save_last[epoch]
        got = tm.update(epoch, metrics, {"w": torch.from_numpy(w)},
                        opt_state={"mu": torch.from_numpy(mu)},
                        step=5 * epoch, model_cfg=model_cfg, save_last=last)
        want = jm.update(epoch, metrics, {"w": w}, opt_state={"mu": mu},
                         step=5 * epoch, model_cfg=model_cfg, save_last=last)
        assert got == want, (case, epoch)
        assert tm.best_value == jm.best_value
    assert _files(tdir, "") == _files(jdir, ""), case
    for sub in ("best-model-ckpt/model_cfg.json",
                "last-model-ckpt/train_meta.json",
                "last-model-ckpt/model_cfg.json"):
        if (jdir / sub).exists():
            assert (json.loads((tdir / sub).read_text())
                    == json.loads((jdir / sub).read_text())), sub
    for f in jdir.rglob("*.msgpack"):
        assert (tdir / f.relative_to(jdir)).read_bytes() == f.read_bytes()
    ex = {"w": np.zeros((3, 2), np.float32)}
    np.testing.assert_array_equal(tm.restore_best()["w"].numpy(),
                                  jm.restore_best(ex)["w"])
    t_params, t_opt, t_meta = tm.restore_last()
    j_params, j_opt, j_meta = jm.restore_last(ex, {"mu": np.zeros(3)})
    np.testing.assert_array_equal(t_params["w"].numpy(), j_params["w"])
    np.testing.assert_array_equal(t_opt["mu"].numpy(), j_opt["mu"])
    assert t_meta == j_meta
    # each package's reader on the other's files
    np.testing.assert_array_equal(
        jckpt.CheckpointManager(tdir, "m").restore_last(ex)[0]["w"],
        tckpt.CheckpointManager(jdir, "m").restore_last()[0]["w"].numpy())
    for epoch_dir in (jdir / "model-ckpts").glob("e*"):
        np.testing.assert_array_equal(
            tckpt.read_params(tdir / "model-ckpts" / epoch_dir.name)[
                "w"].numpy(),
            jckpt.load_pytree(epoch_dir / "params.msgpack", ex)["w"])


def test_save_interrupt_and_restore_last(tmp_path):
    jm = jckpt.CheckpointManager(tmp_path / "jax", "m")
    tm = tckpt.CheckpointManager(tmp_path / "port", "m")
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    for m, tree in ((jm, {"w": w}), (tm, {"w": torch.from_numpy(w)})):
        m.update(0, {"m": 0.25}, tree, step=3)
    opt = {"mu": torch.full((3, 2), 0.5), "count": np.array(9, np.int32)}
    tm.save_interrupt(2, {"w": torch.from_numpy(w + 1)}, opt_state=opt,
                      step=9, model_cfg={"kind": "aptai"})
    jm.save_interrupt(2, {"w": w + 1}, opt_state={
        "mu": np.full((3, 2), 0.5, np.float32),
        "count": np.array(9, np.int32)},
        step=9, model_cfg={"kind": "aptai"})
    meta_path = "last-model-ckpt/train_meta.json"
    t_meta = json.loads((tmp_path / "port" / meta_path).read_text())
    assert t_meta == json.loads((tmp_path / "jax" / meta_path).read_text())
    assert t_meta == {"epoch": 1, "step": 9, "best_value": 0.25,
                      "metrics": {}, "preempted": True}

    fresh = tckpt.CheckpointManager(tmp_path / "port", "m")
    assert fresh.best_value is None and fresh.has_last()
    params, opt_state, meta = fresh.restore_last()
    assert meta == t_meta and fresh.best_value == 0.25
    np.testing.assert_array_equal(params["w"].numpy(), w + 1)
    assert torch.equal(opt_state["mu"], opt["mu"])
    assert opt_state["count"] == 9
    for f in ("params.msgpack", "opt_state.msgpack"):
        assert ((tmp_path / "port" / "last-model-ckpt" / f).read_bytes()
                == (tmp_path / "jax" / "last-model-ckpt" / f).read_bytes())


def test_older_port_run_pt_restores(tmp_path):
    """A directory of an older run of the port (``params.pt``,
    ``opt_state.pt``) restores as it did; the next write replaces the
    ``.pt`` files with ``.msgpack`` ones, so none is left stale."""
    last = tmp_path / "last-model-ckpt"
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    opt = {"state": {0: {"step": torch.tensor(4.0),
                         "exp_avg": torch.full((3, 2), 0.5)}},
           "param_groups": [{"lr": 1e-4, "params": [0]}]}
    tckpt.save_state(last / "params.pt", {"w": w})
    tckpt.save_state(last / "opt_state.pt", opt)
    tckpt.save_json(last / "train_meta.json",
                    {"epoch": 0, "step": 4, "best_value": 0.5,
                     "metrics": {}})
    manager = tckpt.CheckpointManager(tmp_path, "m")
    assert manager.has_last()
    params, opt_state, meta = manager.restore_last()
    assert torch.equal(params["w"], w) and meta["step"] == 4
    assert opt_state["param_groups"] == opt["param_groups"]
    assert torch.equal(opt_state["state"][0]["exp_avg"],
                       opt["state"][0]["exp_avg"])
    manager.update(1, {"m": 0.25}, {"w": w + 1}, opt_state={"mu": w},
                   step=6)
    assert sorted(p.name for p in last.iterdir()) == [
        "opt_state.msgpack", "params.msgpack", "train_meta.json"]
    params, opt_state, meta = manager.restore_last()
    assert torch.equal(params["w"], w + 1) and meta["step"] == 6
    assert torch.equal(opt_state["mu"], w)
