"""aptai_tpu_torch's model axis in serving and in ``fit``, on two gloo
ranks of a 1 × 2 mesh (one spawn, ``_torch_parallel_worker.py``, importing
the port only), against the JAX package's single-device programs:

* ``APTAIPredictor`` (also with sequence parallelism), ``W2V2PRPredictor``
  and ``ForceAPTAIPredictor`` with ``mesh=``, ``load_predictor(mesh=)``
  and ``StreamingAPTAI(mesh=)``: every rank returns the single device's
  outputs, within 1e-5 of the largest magnitude of the JAX predictor's
  (FORCE and the streamer: 1e-4, the tolerance of their single-device
  parity tests, ``tests/test_torch_force.py`` and
  ``tests/test_torch_streaming.py``: the BiLSTM carries float32 rounding
  along the sequence);
* W8A8 on the model axis: the row-parallel layers' scales are maxima over
  the axis and their int32 products are summed over it before the
  dequantization, so the predictor equals the unsharded quantized one bit
  for bit; the encoder given the JAX package's codes is within ``rtol=1e-4,
  atol=1e-5`` of the JAX encoder (``tests/test_quant.py``'s tolerance),
  its own codes at most one step from JAX's and at ties only, counted as
  ``tests/test_torch_quant.py`` counts them;
* dropout: the tensors both ranks hold draw the single device's masks,
  the FFN's hidden units their own (a deliberate divergence);
* ``fit`` with ``mesh_model=2``: its checkpoints are a single device's
  files (at learning rate 0 the one-process run's ``params.msgpack`` byte
  for byte), its steps the one-process run's, and a resume shards the
  files back.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from aptai_tpu.infer import APTAIPredictor as JaxAPTAIPredictor
from aptai_tpu.infer import ForceAPTAIPredictor as JaxForcePredictor
from aptai_tpu.infer import W2V2PRPredictor as JaxW2V2PRPredictor
from aptai_tpu.infer import streaming as jstreaming
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.aptai import APTAI
from aptai_tpu_torch.models.convert import (force_aptai_state_dict_from_jax,
                                            state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.models.wav2vec2 import init_weights_
from aptai_tpu_torch.train.checkpoints import CheckpointManager, read_params

import _torch_parallel_worker as worker
from _torch_port import (NO_DROP, jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)
from test_torch_parallel import ZERO_GRAD, _batch
from test_torch_parallel_fit import _items
from test_torch_quant import ENCODER_TOL, MAX_FLIP_SHARE, _jax_rows

V = worker.NUM_PHN
STACK = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
DET = dict(NO_DROP, mask_time_prob=0.0)
CHUNKING = dict(chunk_seconds=1.0, overlap_seconds=0.25, chunk_batch=2)
DROPOUTS = {
    "drop_replicated": dict(DET, hidden_dropout=0.1, attention_dropout=0.1,
                            feat_proj_dropout=0.1),
    "drop_ffn": dict(DET, activation_dropout=0.1)}
LR = 1e-2  # the largest LR of the fit runs' schedule (test_torch_parallel_fit)
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


def _checkpoint(root, cfg_t, sd):
    """A trainer's APTAI checkpoint directory of the port's manager."""
    model = APTAI(cfg_t, num_phonemes=V)
    model.load_state_dict(sd)
    CheckpointManager(root, "m").update(
        0, {"m": 1.0}, model.state_dict(), model_cfg={
            "backbone": dataclasses.asdict(cfg_t), "kind": "aptai",
            "vocab": {f"p{i}": i for i in range(V)}})
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_serving")
    cfg_t, cfg_j = tcfg.tiny_config(**STACK), jcfg.tiny_config(**STACK)
    p_aptai = random_jax_aptai_params(cfg_t, V, seed=51)
    p_pr = random_jax_w2v2_pr_params(cfg_t, seed=52)
    p_force = random_jax_force_params(cfg_j, V, seed=53)
    rng = np.random.default_rng(54)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 11_000, 6_500)]
    long = (rng.standard_normal(52_800) * 0.1).astype(np.float32)
    train = APTAI(tcfg.tiny_config(**DET), num_phonemes=V)
    init_weights_(train, torch.Generator().manual_seed(3))
    sd_serve = state_dict_from_jax(p_aptai)
    # the JAX W8A8 encoder's output and the codes of each quantized
    # layer's input (test_torch_quant.py's case), for the ranks to take
    p_quant = random_jax_aptai_params(tcfg.tiny_config(**NO_DROP), V, seed=2)
    audio = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    audio[1, 2500:] = 0.0
    lens = np.array([4000, 2500], np.int32)
    with pytest.MonkeyPatch.context() as mp:
        quant_h, rows = _jax_rows("w8a8", p_quant, audio, lens, mp)
    quant = {"cfg": dict(NO_DROP, quant="w8a8"), "audio": audio,
             "lens": lens, "sd": state_dict_from_jax(p_quant),
             "rows": [(r.codes.numpy(), r.scale.numpy()) for r in rows]}
    inp = {"cfg": STACK, "wavs": wavs, "long": long, "chunking": CHUNKING,
           "sd_serve": sd_serve, "sd_pr": w2v2_pr_state_dict_from_jax(p_pr),
           "force_cfg": dataclasses.asdict(cfg_t),
           "sd_force": force_aptai_state_dict_from_jax(p_force),
           "ckpt": str(_checkpoint(root / "ckpt", cfg_t, sd_serve)),
           "dropouts": DROPOUTS, "det": DET, "sd": train.state_dict(),
           "batch": _batch(tcfg.tiny_config(**DET)),
           "items": _items(tcfg.tiny_config(**DET)), "val": [3.0, 2.0],
           "root": str(root / "ranks"), "quant": quant}
    return {"inp": inp, "root": root, "cfg_j": cfg_j, "p_aptai": p_aptai,
            "p_pr": p_pr, "p_force": p_force, "quant_h": quant_h}


@pytest.fixture(scope="module")
def spawned(setup):
    return worker.start("tensor_serving", setup["inp"], setup["root"] / "w")


@pytest.fixture(scope="module")
def ref(setup, spawned):
    """The JAX package's single-device predictors and streamer, and the
    port's one-process steps and fits (made while the ranks run)."""
    inp, cfg_j = setup["inp"], setup["cfg_j"]
    wavs = inp["wavs"]
    aptai_j = JaxAPTAI(cfg_j, num_phonemes=V, tv_drop=0.0, phn_drop=0.0)
    out = {
        "aptai": JaxAPTAIPredictor(aptai_j, setup["p_aptai"])
        .predict_batch(wavs),
        "w2v2_pr": JaxW2V2PRPredictor(JaxW2V2PR(cfg_j), setup["p_pr"])
        .encode_batch(wavs),
        "force": JaxForcePredictor(JaxForceAPTAI(cfg_j, vocab_size=V),
                                   setup["p_force"]).predict_batch(wavs),
        "stream": jstreaming.StreamingAPTAI(
            aptai_j, jax.tree.map(np.asarray, setup["p_aptai"]),
            **CHUNKING).predict(inp["long"])}
    out = {k: jax.tree.map(np.asarray, v) for k, v in out.items()}
    for name, kw in DROPOUTS.items():
        out[name] = worker.sgd_steps(worker.aptai(kw, inp["sd"]),
                                     inp["batch"], None, False, n=1)
    one = setup["root"] / "one"
    out["fit"] = worker.run_fit(inp, one / "tp", False, 2, False)
    worker.run_fit(inp, one / "tp_resumed", False, 1, False)
    out["fit_resumed"] = worker.run_fit(inp, one / "tp_resumed", False, 2,
                                        True)
    out["fit_lr0"] = worker.run_fit(inp, one / "tp_lr0", False, 1, False,
                                    lr=0.0)
    return out


@pytest.fixture(scope="module")
def ranks(spawned, ref):
    return worker.finish(spawned)


def _assert_outputs(got, want, tol=1e-5):
    """Every output of the JAX predictor: integers equal on valid frames,
    the rest within ``tol`` of the largest magnitude."""
    lengths = want["frame_lengths"]
    assert set(want) <= set(got), set(want) - set(got)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if not np.issubdtype(w.dtype, np.floating):
            for b, n in enumerate(lengths):
                np.testing.assert_array_equal(
                    g[b, :n] if g.ndim > 1 else g[b],
                    w[b, :n] if w.ndim > 1 else w[b], err_msg=k)
            continue
        np.testing.assert_allclose(g.astype(np.float32), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("name,family,tol", [
    ("aptai", "aptai", 1e-5), ("aptai_sp", "aptai", 1e-5),
    ("w2v2_pr", "w2v2_pr", 1e-5), ("force", "force", 1e-4)])
def test_predictors_on_the_model_axis_match_jax(ranks, ref, name, family,
                                                tol):
    """The predictor on the 1 × 2 mesh (``aptai_sp``: the residual stream
    split over time too), on each rank, against the JAX predictor."""
    for out in ranks:
        _assert_outputs(out[name], ref[family], tol)


def test_load_predictor_on_a_mesh(ranks, ref):
    """``load_predictor(ckpt, mesh=)`` serves the checkpoint's APTAI over
    the mesh: the live TP predictor's outputs, bit for bit, and so the
    JAX predictor's."""
    for out in ranks:
        for k, v in out["aptai"].items():
            np.testing.assert_array_equal(out["loaded"][k], v, err_msg=k)
        _assert_outputs(out["loaded"], ref["aptai"])


def test_streamer_on_a_mesh_matches_jax(ranks, ref):
    """``StreamingAPTAI(mesh=)``: each group's two chunks on the model axis
    (a data axis of one takes both), stitched as the JAX streamer's."""
    want = ref["stream"]
    for out in ranks:
        got = out["stream"]
        tv = np.stack([got["tvs_pred"][k] for k in TV_ORDER], axis=1)
        w = np.stack([want["tvs_pred"][k] for k in TV_ORDER], axis=1)
        np.testing.assert_allclose(tv, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_array_equal(got["phn_fc_pred"],
                                      want["phn_fc_pred"])


def test_w8a8_on_the_model_axis(ranks, setup):
    """``quant="w8a8"`` on the 1 × 2 mesh: the predictor bit for bit the
    unsharded quantized one (the row-parallel scales and int32 sums are
    the unsharded layer's). The encoder free within ``ENCODER_TOL`` of the
    JAX encoder (a code a tie rounds the other way moves every later
    activation); given the JAX codes and scales for each quantized layer's
    input, within ``rtol=1e-4, atol=1e-5``; each rank's own codes (its
    columns of a row-parallel layer's input) one step from JAX's at most,
    at ties only."""
    want = setup["quant_h"]
    jrows = setup["inp"]["quant"]["rows"]
    for r, out in enumerate(ranks):
        for k, v in out["w8a8_single"].items():
            np.testing.assert_array_equal(out["w8a8"][k], v, err_msg=k)
        enc = out["w8a8_encoder"]
        rel = np.linalg.norm(enc["free"] - want) / np.linalg.norm(want)
        assert rel <= ENCODER_TOL, rel
        np.testing.assert_allclose(enc["forced"], want, rtol=1e-4,
                                   atol=1e-5)
        assert len(enc["codes"]) == len(jrows)
        flips = total = 0
        for codes, (jcodes, _) in zip(enc["codes"], jrows):
            if codes.shape != jcodes.shape:  # a row-parallel input: halves
                k = codes.shape[-1]
                jcodes = jcodes[..., r * k:(r + 1) * k]
            diff = np.abs(codes.astype(np.int32) - jcodes.astype(np.int32))
            assert int(diff.max()) <= 1
            flips += int((diff != 0).sum())
            total += codes.size
        assert flips <= MAX_FLIP_SHARE * total, (flips, total)


def test_replicated_dropout_draws_the_single_devices_masks(ranks, ref):
    """Dropout on the tensors both ranks hold (after the projections, the
    residual stream) draws the single device's masks: each rank seeds its
    generator alike, and the FFN draws nothing here, so a TP step equals
    the port's one-process step."""
    want = ref["drop_replicated"]
    for out in ranks:
        got = out["drop_replicated"]
        assert abs(got["loss"] - want["loss"]) < 1e-5
        for name, w in want["params"].items():
            if name.endswith(ZERO_GRAD):
                continue
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       w.numpy(), rtol=2e-3, atol=1e-6,
                                       err_msg=name)


def test_ffn_dropout_draws_its_own_masks(ranks, ref):
    """The deliberate divergence: the FFN's dropout after the GELU acts on
    each rank's hidden units and draws a mask of its own, not a slice of
    the single device's. The ranks agree with each other (the reduced
    output is the same on both), not with the one-process step."""
    (r0, r1), want = (out["drop_ffn"] for out in ranks), ref["drop_ffn"]
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - want["loss"]) > 1e-4


def _assert_close(got_dir, want_dir):
    got, want = read_params(got_dir), read_params(want_dir)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith(ZERO_GRAD):
            assert (g - w).abs().max() <= 2 * LR * STEPS, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)


def test_tp_fit_writes_a_single_devices_checkpoint(ranks, ref, setup):
    """Rank 0 alone writes; the files hold whole tensors: at learning rate
    0 the TP run's ``params.msgpack`` is the one-process run's byte for
    byte, and its Adam moments have the single device's shapes."""
    tp = setup["root"] / "ranks" / "tp_lr0" / "last-model-ckpt"
    one = setup["root"] / "one" / "tp_lr0" / "last-model-ckpt"
    assert (tp / "params.msgpack").read_bytes() == \
        (one / "params.msgpack").read_bytes()
    r0, r1 = (out["fit_lr0"] for out in ranks)
    assert r0["wrote"]["bytes"] > 0 and r1["wrote"] == {}
    assert r0["files"] == ref["fit_lr0"]["files"]
    assert json.loads((tp / "train_meta.json").read_text())["step"] == 2


def test_tp_fit_matches_one_process(ranks, ref, setup):
    """Two epochs with ``mesh_model=2``: each rank takes the whole batch
    (a data axis of one), the best and last checkpoints are the
    one-process run's within the step tolerance, and the losses agree."""
    for ckpt in ("best-model-ckpt", "last-model-ckpt"):
        _assert_close(setup["root"] / "ranks" / "tp" / ckpt,
                      setup["root"] / "one" / "tp" / ckpt)
    for out in ranks:
        assert out["fit"]["rows"] == 4
        got = [float(x.split("train_loss=")[1].split()[0])
               for x in out["fit"]["logs"]]
        want = [float(x.split("train_loss=")[1].split()[0])
                for x in ref["fit"]["logs"]]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tp_resume_shards_the_checkpoint_back(ranks, setup):
    """A TP run stopped after one epoch and resumed from its files: both
    ranks resume at epoch 1, and the run ends where the one-process run
    resumed the same way does."""
    for out in ranks:
        assert out["fit_resumed"]["logs"][0].startswith(
            "resumed from epoch 0")
        assert out["fit_resumed"]["seen"] == [1]
    _assert_close(setup["root"] / "ranks" / "tp_resumed" / "last-model-ckpt",
                  setup["root"] / "one" / "tp_resumed" / "last-model-ckpt")


def test_children_import_only_the_port(ranks):
    assert [out["jax_loaded"] for out in ranks] == [False, False]
