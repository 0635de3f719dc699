"""aptai_tpu_torch's ``fit`` over two gloo ranks on the CPU (one spawn,
``_torch_parallel_worker.py``, importing the port only): the loader's
split, checkpoints written by rank 0 alone while rank 1 waits at the
barrier, an FSDP run's gathered checkpoint and its sharded resume, and a
preemption signal that reaches one rank stopping both at the same step.
The ranks' files are held to a one-process ``fit`` of the same global
batches. Their bytes differ: the all-reduce sums the two ranks' gradients
in another order, and Adam scales the roundoff of the key projection's
exactly-zero bias gradient up to the learning rate; the restored values
are compared with ``tests/test_parallel.py``'s tolerance instead."""

import numpy as np
import pytest
import torch

from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.aptai import APTAI
from aptai_tpu_torch.models.wav2vec2 import init_weights_
from aptai_tpu_torch.train import loop
from aptai_tpu_torch.train.checkpoints import (load_flax_params, load_json,
                                               read_params)

import _torch_parallel_worker as worker
from _torch_port import NO_DROP, one_torch_thread

DET = dict(NO_DROP, mask_time_prob=0.0)
ZERO_GRAD = "attention.k_proj.bias"
STEPS = 4  # two epochs of two global batches
LR = 1e-2  # the schedule's largest LR in these runs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _items(cfg, n=8, seed=1):
    """``collate_tv`` items of two lengths, in one loader bucket."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        a = int(rng.choice([2400, 3200]))
        t = int(cfg.feat_extract_output_lengths(a))
        items.append({
            "audio": (rng.standard_normal(a) * 0.1).astype(np.float32),
            "audio_len": a,
            "phn_frames_49hz": rng.integers(1, worker.NUM_PHN,
                                            t).astype(np.int32),
            "tvs_norm_49hz_array": rng.standard_normal(
                (t, 9)).astype(np.float32),
            "phoneme_label": rng.integers(1, worker.NUM_PHN,
                                          5).astype(np.int32)})
    return items


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' runs, and the one-process runs they are held to
    (made while the ranks run)."""
    root = tmp_path_factory.mktemp("fit")
    model = APTAI(tcfg.tiny_config(**DET), num_phonemes=worker.NUM_PHN)
    init_weights_(model, torch.Generator().manual_seed(3))
    inp = {"det": DET, "sd": model.state_dict(),
           "items": _items(tcfg.tiny_config(**DET)), "val": [3.0, 2.0],
           "root": str(root / "ranks")}
    started = worker.start("fits", inp, root / "work")
    one = root / "one"
    single = {"dp": worker.run_fit(inp, one / "dp", False, 2, False),
              "first": worker.run_fit(inp, one / "resumed", False, 1,
                                      False)}
    single["resumed"] = worker.run_fit(inp, one / "resumed", False, 2, True)
    return {"ranks": worker.finish(started), "single": single,
            "root": root}


def _assert_close(got_dir, want_dir):
    got, want = read_params(got_dir), read_params(want_dir)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith(ZERO_GRAD):
            assert (g - w).abs().max() <= 2 * LR * STEPS, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)


def test_each_rank_trains_its_rows_and_only_rank_0_writes(runs):
    """Each rank takes two rows of every four-row batch and validates
    every epoch; rank 0 alone writes (its manager timed the writes; rank
    1's never wrote) and logs ``*best*``; after ``fit`` both see the
    files."""
    r0, r1 = (out["dp"] for out in runs["ranks"])
    assert r0["rows"] == r1["rows"] == 2
    assert r0["seen"] == r1["seen"] == [0, 1]
    assert r0["wrote"]["bytes"] > 0 and r1["wrote"] == {}
    assert "*best*" in r0["logs"][-1] and "*best*" not in r1["logs"][-1]
    assert [line.split(" val_")[0] for line in r0["logs"]] == \
        [line.split(" val_")[0] for line in r1["logs"]]
    assert r0["files"] == r1["files"] == runs["single"]["dp"]["files"]


def test_two_rank_fit_matches_one_process(runs):
    """The DP run's best and last checkpoints against the one-process
    run's; both runs' losses agree per epoch."""
    dp = runs["root"] / "ranks" / "dp"
    one = runs["root"] / "one" / "dp"
    for ckpt in ("best-model-ckpt", "last-model-ckpt"):
        _assert_close(dp / ckpt, one / ckpt)
    got = [float(x.split("train_loss=")[1].split()[0])
           for x in runs["ranks"][0]["dp"]["logs"]]
    want = [float(x.split("train_loss=")[1].split()[0])
            for x in runs["single"]["dp"]["logs"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert load_json(dp / "last-model-ckpt" / "train_meta.json")["step"] \
        == STEPS


def test_fsdp_fit_gathers_a_single_devices_checkpoint(runs):
    """Under FSDP the primary writes the whole parameters and the whole
    Adam state (optax tree, full shapes), as the DDP run does."""
    fsdp = runs["root"] / "ranks" / "fsdp" / "last-model-ckpt"
    dp = runs["root"] / "ranks" / "dp" / "last-model-ckpt"
    _assert_close(fsdp, dp)
    got, want = (load_flax_params(d / "opt_state.msgpack")
                 for d in (fsdp, dp))
    assert {k: v.shape for k, v in _flatten(got, "")} == \
        {k: v.shape for k, v in _flatten(want, "")}
    assert int(got["0"]["count"]) == STEPS


def _flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_fsdp_resume_shards_the_checkpoint_back(runs):
    """An FSDP run stopped after one epoch and resumed from its files for a
    second: it resumes at epoch 1 on both ranks and ends where the
    one-process run resumed the same way does."""
    for out in runs["ranks"]:
        resumed = out["fsdp_resumed"]
        assert resumed["logs"][0].startswith("resumed from epoch 0")
        assert resumed["seen"] == [1]
    _assert_close(runs["root"] / "ranks" / "fsdp_resumed" / "last-model-ckpt",
                  runs["root"] / "one" / "resumed" / "last-model-ckpt")


def test_a_signal_to_one_rank_stops_both(runs):
    """SIGUSR1 reaches rank 1 alone during the second batch: both ranks
    finish that step, rank 0 writes the resume checkpoint, both raise
    ``Preempted``."""
    r0, r1 = (out["signalled"] for out in runs["ranks"])
    assert r0["preempted"] and r1["preempted"]
    assert r0["seen"] == r1["seen"] == []
    assert "after 2 steps" in r0["logs"][-1] and \
        "after 2 steps" in r1["logs"][-1]
    meta = load_json(runs["root"] / "ranks" / "signalled" / "last-model-ckpt"
                     / "train_meta.json")
    assert meta["preempted"] and meta["step"] == 2 and meta["epoch"] == -1
    assert r1["wrote"] == {}


def test_children_import_only_the_port(runs):
    assert [out["jax_loaded"] for out in runs["ranks"]] == [False, False]


def test_training_loader_must_split():
    """``split_rows`` reaches a bucketed loader through ``.loader`` and
    refuses a loader it cannot split, or a batch that does not divide."""
    from aptai_tpu_torch.data.batching import BucketedLoader, PrefetchLoader

    inner = BucketedLoader([], 4, dict)
    loop.split_rows(PrefetchLoader(inner), 1, 2)
    assert (inner.process_index, inner.process_count) == (1, 2)
    with pytest.raises(ValueError, match="not divisible"):
        loop.split_rows(inner, 0, 3)
    with pytest.raises(TypeError, match="BucketedLoader"):
        loop.split_rows([{"audio": 0}], 0, 2)
