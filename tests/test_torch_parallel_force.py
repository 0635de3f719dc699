"""aptai_tpu_torch's FORCE-APTAI training over two gloo ranks on the CPU (one
spawn, ``_torch_parallel_worker.py``, importing the port only), against the
JAX package's single-device step and against one process of the port:

* two SGD steps of FORCE's head from cached encodings on a (2, 1) mesh,
  each rank on its rows of a global batch whose TV targets and tower
  labels are masked unevenly over the ranks (rank 0's rows long and
  mostly voiced, rank 1's short and mostly blank), against the JAX
  ``train_from_encoded`` step on the whole batch: losses within 1e-5
  relative, the head's parameters within ``tests/test_parallel.py``'s
  tolerance. The mean of the two ranks' own masked means is checked to
  miss the global one, so a per-process mean would fail;
* the split cache passes (``FrozenEncodedCorpus`` greedy and
  ``beam_host``, ``FECachedLoader``): every rank holds the items of a
  one-process pass, in its order, the decoded sequences equal and the
  embeddings within 1e-5 relative, while each call of the tower (or the
  feature extractor) on a rank encodes half a batch;
* ``train_force_aptai.run`` on two ranks under DDP, ``--fsdp`` and
  ``--mesh_model 2`` over a synthetic HPRC corpus and a tiny W2V2PR
  checkpoint (the corpus cache): rank 0 alone writes, and its merged
  checkpoint and CSVs equal a one-process run's; a decode collapse seen
  by rank 0's validation alone makes both ranks fall back to
  ``beam_host``.

The head's dropout is off in every parity step and run: each rank draws
its own rows' masks.
"""

import functools
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch.data import (BucketedLoader, HPRCDataset, build_vocab,
                                  collate_tv, make_synthetic_hprc)
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import (force_aptai_state_dict_from_jax,
                                    random_w2v2_pr)
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import state_dict_from_jax
from aptai_tpu_torch.train import (FECachedLoader, FrozenEncodedCorpus,
                                   builders, train_force_aptai)
from aptai_tpu_torch.train.checkpoints import CheckpointManager, read_params
from aptai_tpu_torch.train.config import ForceAPTAIConfig

import _torch_parallel_worker as worker
from _torch_port import (NO_DROP, jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_aptai_params, random_jax_w2v2_pr_params)

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
TOWER = dict(STACK, **NO_DROP)
V = 11
AUX = 0.1
LR = 1e-2
LOSSES = ("loss", "tv_loss", "align_loss", "aux_ce")
ITEM_KEYS = ("utt_key", "frame_embs", "frame_length", "frame_length_raw",
             "phn_pred_seq", "phn_seq_length", "phn_seq_truncated",
             "tower_frame_labels", "tv_targets", "phn_frames",
             "phoneme_label")
FE_ITEM_KEYS = ("fe_features", "audio_length", "frame_length", "tv_targets",
                "phn_frames", "phoneme_label")
RUN_LR = 1e-4  # the schedule holds 10x this after its warmup
RUNS = {"dp": ({}, ["M01", "F02"]), "fsdp": ({"fsdp": True}, ["M01"]),
        "tp": ({"mesh_model": 2}, ["M01"]),
        "collapse": ({"collapse_fallback": True, "collapse_patience": 1},
                     ["M01"])}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


def _encoded(seed=30):
    """A global batch of head inputs: rank 0's rows (0, 1) hold 99 and 80
    frames with tower labels mostly non-blank, rank 1's 20 and 7 frames
    with labels mostly blank, so their TV and aux-CE masks are uneven."""
    rng = np.random.default_rng(seed)
    fl = np.array([99, 80, 20, 7], np.int32)
    sl = np.array([40, 30, 12, 4], np.int32)
    seq = np.zeros((4, 60), np.int32)
    for b in range(4):
        seq[b, :sl[b]] = rng.integers(1, V, sl[b])
    tv = rng.standard_normal((4, 99, 9)).astype(np.float32)
    labels = rng.integers(1, V, (4, 99)).astype(np.int32)
    labels[2:][rng.random((2, 99)) < 0.8] = 0
    for b in range(4):
        tv[b, fl[b]:] = -100.0
    return {"frame_embs": rng.standard_normal((4, 99, 32)).astype(
                np.float32),
            "enc_frame_lengths": fl, "phn_pred_seq": seq,
            "phn_seq_lengths": sl, "phn_seq_truncated": np.zeros(4, np.int32),
            "tv_targets": tv, "tower_frame_labels": labels}


def _jax_model():
    return JaxForceAPTAI(jcfg.tiny_config(**STACK), vocab_size=V,
                         aux_frame_ce_weight=AUX)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("force_ranks")
    enc = _encoded()
    model = _jax_model()
    args = tuple(enc[k] for k in (
        "frame_embs", "enc_frame_lengths", "phn_pred_seq",
        "phn_seq_lengths", "phn_seq_truncated", "tv_targets"))
    head = jax.jit(functools.partial(model.init, method="train_from_encoded"))(
        jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(31)
    head = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), jax.device_get(head))
    params = dict(head, w2v2_pr=random_jax_w2v2_pr_params(
        tcfg.tiny_config(**STACK), seed=32))
    hprc = make_synthetic_hprc(root / "hprc", 2, ("M01", "F02", "M03"),
                               device="cpu")
    rows = read_rows(hprc)
    vocab = build_vocab(r["phoneme_labels"] for r in rows)
    # the W2V2PR run FORCE's trainer splices its tower from
    pr_cfg = tcfg.tiny_config(**TOWER, vocab_size=len(vocab))
    pr = random_w2v2_pr(pr_cfg, seed=33)
    CheckpointManager(root / "pr", "val_loss").update(
        0, {"val_loss": 1.0}, pr.state_dict(),
        model_cfg={"kind": "w2v2_pr", "vocab": vocab})
    aptai_det = dict(NO_DROP, mask_time_prob=0.0)
    inp = {"force": {"cfg": STACK, "kw": {"vocab_size": V,
                                          "aux_frame_ce_weight": AUX},
                     "sd": force_aptai_state_dict_from_jax(params)},
           "encoded": enc, "lr": LR, "rows": rows, "vocab": vocab,
           "cache_batch": 4, "item_keys": ITEM_KEYS,
           "fe_item_keys": FE_ITEM_KEYS, "aptai_cfg": aptai_det,
           "sd_aptai": state_dict_from_jax(random_jax_aptai_params(
               tcfg.tiny_config(**aptai_det), worker.NUM_PHN, seed=34)),
           "root": str(root / "runs"), "force_runs": RUNS,
           "force_run_cfg": dict(
               hprc_csv_path=str(hprc), pr_model_path=str(root / "pr"),
               vocab_path="", laptop=True, batch_size=2, num_epochs=2,
               learning_rate=RUN_LR, platform="cpu")}
    return {"inp": inp, "params": params, "root": root, "args": args}


@pytest.fixture(scope="module")
def spawned(setup):
    return worker.start("force_parallel", setup["inp"],
                        setup["root"] / "work")


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    """The JAX package's single-device FORCE step from encoded inputs, two
    SGD steps of the head on the global batch, in one compiled program."""
    model = _jax_model()
    labels = setup["inp"]["encoded"]["tower_frame_labels"]

    def loss(head, tower):
        out = model.apply({"params": dict(head, w2v2_pr=tower)},
                          *setup["args"], tower_frame_labels=labels,
                          method="train_from_encoded")
        return out["loss"], {k: out[k] for k in LOSSES}

    def steps(params):
        head = {k: v for k, v in params.items() if k != "w2v2_pr"}
        outs = []
        for _ in range(2):
            (_, out), g = jax.value_and_grad(loss, has_aux=True)(
                head, params["w2v2_pr"])
            head = jax.tree.map(lambda p, d: p - LR * d, head, g)
            outs.append(out)
        return head, outs

    head, outs = jax.device_get(jax.jit(steps)(setup["params"]))
    want = force_aptai_state_dict_from_jax(
        dict(head, w2v2_pr=setup["params"]["w2v2_pr"]))
    return ({k: v.numpy() for k, v in want.items()
             if not k.startswith("w2v2_pr.")},
            [{k: float(v) for k, v in o.items()} for o in outs])


@pytest.fixture(scope="module")
def one_process(setup, spawned):
    """The port in one process: each half batch's own masked means, the
    cache passes, and ``train_force_aptai.run``."""
    inp = setup["inp"]
    model = worker.force_model(inp).train()
    enc = {k: torch.from_numpy(v) for k, v in inp["encoded"].items()}
    keys = ("frame_embs", "enc_frame_lengths", "phn_pred_seq",
            "phn_seq_lengths", "phn_seq_truncated", "tv_targets")
    halves = []
    with torch.no_grad():
        for rows in (slice(0, 2), slice(2, 4)):
            out = model.train_from_encoded(
                *(enc[k][rows] for k in keys),
                tower_frame_labels=enc["tower_frame_labels"][rows])
            halves.append({k: out[k].item() for k in ("tv_loss", "aux_ce")})
    caches = {}
    for method in ("greedy", "beam_host"):
        corpus = FrozenEncodedCorpus(inp["rows"], inp["vocab"],
                                     worker.force_model(
                                         inp, decode_method=method),
                                     inp["cache_batch"])
        caches[method] = {"keys": list(corpus.by_key),
                          "items": list(corpus.by_key.values())}
    loader = BucketedLoader(HPRCDataset(inp["rows"], inp["vocab"],
                                        rate="both"),
                            batch_size=inp["cache_batch"],
                            collate_fn=collate_tv, shuffle=False)
    caches["fe"] = {"items": FECachedLoader(
        loader, worker.aptai(inp["aptai_cfg"], inp["sd_aptai"]),
        shuffle=False).dataset.items}
    exp = setup["root"] / "one"
    cfg = ForceAPTAIConfig(exp_dir=str(exp), **inp["force_run_cfg"]
                           ).finalize("FORCE_APTAI")
    real = builders.random_force_aptai
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builders, "random_force_aptai", lambda *a, **k: real(
            *a, **dict(k, hidden_drop=0.0, rnn_drop=0.0)))
        mean, _, per = train_force_aptai.run(
            cfg, tcfg.tiny_config(**inp["force"]["cfg"]),
            RUNS["dp"][1])
    return {"halves": halves, "caches": caches, "exp": exp,
            "mean": mean, "per": per}


@pytest.fixture(scope="module")
def ranks(spawned, jax_steps, one_process):
    return worker.finish(spawned, timeout=400)


def test_head_step_matches_the_jax_single_device_step(ranks, jax_steps):
    """Both steps' losses (the ranks' mean: each rank's value is its share
    of the global masked means) and the head after two SGD steps."""
    want_params, want = jax_steps
    for s in range(2):
        for k in LOSSES:
            got = np.mean([r["head"]["seen"][s][k] for r in ranks])
            assert got == pytest.approx(want[s][k], rel=1e-5), (s, k)
    for r in ranks:
        got = r["head"]["params"]
        assert set(got) == set(want_params)
        for name, w in want_params.items():
            np.testing.assert_allclose(got[name].numpy(), w, rtol=2e-3,
                                       atol=1e-6, err_msg=name)


def test_per_rank_masked_means_would_miss(jax_steps, one_process):
    """The masks are uneven enough that the mean of each half batch's own
    masked means is not the global masked mean."""
    want = jax_steps[1][0]
    for k in ("tv_loss", "aux_ce"):
        local = np.mean([h[k] for h in one_process["halves"]])
        assert abs(local - want[k]) > 1e-2 * abs(want[k]), k


def _items_equal(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            if gv.dtype.kind == "f":
                np.testing.assert_allclose(gv, wv, rtol=1e-5,
                                           atol=1e-5 * np.abs(wv).max())
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=k)


@pytest.mark.parametrize("method", ["greedy", "beam_host"])
def test_split_corpus_cache_gives_every_rank_one_process_items(
        ranks, one_process, method, setup):
    want = one_process["caches"][method]
    for r in ranks:
        got = r["caches"][method]
        assert got["keys"] == want["keys"]
        _items_equal(got["items"], want["items"], ITEM_KEYS)
        # each call encodes this rank's half of a batch of 4
        assert got["rows"] and set(got["rows"]) == {2}
    assert any(it["phn_seq_length"] > 0 for it in want["items"])


def test_split_fe_cache_gives_every_rank_one_process_items(ranks,
                                                           one_process):
    want = one_process["caches"]["fe"]["items"]
    for r in ranks:
        got = r["caches"]["fe"]
        _items_equal(got["items"], want, FE_ITEM_KEYS)
        assert got["rows"] and set(got["rows"]) == {2}


def _adam_close(got, want, steps, what):
    """Parameters a few Adam steps in: each entry within what two steps of
    the schedule's peak LR each way can part (Adam turns the roundoff of a
    gradient near zero into a step either way), all within 1e-4 relative
    L2."""
    assert set(got) == set(want), what
    for k, w in want.items():
        assert (got[k] - w).abs().max() <= 2 * 10 * RUN_LR * steps, (what, k)
    a = torch.cat([got[k].double().ravel() for k in want])
    b = torch.cat([w.double().ravel() for w in want.values()])
    assert (a - b).norm() <= 1e-4 * b.norm(), what


def _csv(path):
    return pd.read_csv(path).iloc[0].to_dict()


@pytest.mark.parametrize("layout", ["dp", "fsdp", "tp"])
def test_run_on_two_ranks_matches_one_process(ranks, one_process, setup,
                                              layout):
    """Rank 0's merged checkpoint (head and tower) and test CSV for M01
    against the one-process run's; the DDP run's LOSO means too."""
    exp = setup["root"] / "runs" / layout
    one = one_process["exp"]
    for sub in ("best-model-ckpt", "last-model-ckpt"):
        got = read_params(exp / "best-model-ckpt-M01" / sub)
        want = read_params(one / "best-model-ckpt-M01" / sub)
        assert any(k.startswith("w2v2_pr.") for k in want)
        _adam_close(got, want, steps=2, what=(layout, sub))
    files = [f"test_metrics/M01.csv"] + (
        ["test_metrics/F02.csv", "loso_mean.csv"] if layout == "dp" else [])
    for f in files:
        got, want = _csv(exp / f), _csv(one / f)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k] == pytest.approx(w, rel=1e-4, abs=1e-6), (f, k)
    for r in ranks:
        assert r["runs"][layout]["per"][0]["decode_fallback"] == 0


def test_only_rank_0_writes(ranks, setup):
    r0, r1 = (r["runs"] for r in ranks)
    for name in RUNS:
        assert r1[name]["writes"] == [], name
        wrote = {p.split(f"/{name}/", 1)[1] for p in r0[name]["writes"]}
        assert {"experiment_args.json", "test_metrics/M01.csv",
                "loso_mean.csv"} <= wrote, name
        assert any(p.startswith("best-model-ckpt-M01/frozen_tower")
                   for p in wrote), name
    args = json.loads((setup["root"] / "runs" / "fsdp" /
                       "experiment_args.json").read_text())
    assert args["fsdp"] is True


def test_collapse_on_one_rank_falls_back_on_both(ranks):
    """Rank 0's validation alone sees the collapse; both ranks refit the
    fold with ``beam_host``."""
    for r in ranks:
        assert r["runs"]["collapse"]["per"][0]["decode_fallback"] == 1


def test_sharded_encode_refuses_a_batch_that_does_not_divide():
    """A cache pass's batch must divide over the data axis, as the
    training loader's must (``loop.split_rows``)."""
    from aptai_tpu_torch.train.frozen_cache import sharded_encode

    class TwoRanks:  # the data axis of a (2, 1) mesh, rank 0
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (2, 1)[dim]

        def get_local_rank(self, axis):
            return 0

    with pytest.raises(ValueError, match="does not divide"):
        sharded_encode(lambda *a: {}, TwoRanks(), np.zeros((3, 8)),
                       np.full(3, 8))


def test_children_import_only_the_port(ranks):
    assert [r["jax_loaded"] for r in ranks] == [False, False]
