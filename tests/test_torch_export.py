"""aptai_tpu_torch's serving bundles (``infer/export.py``) and the
``aptai_torch`` custom ops they hold, float32 on the CPU:

* ``torch.library.opcheck`` on every op's CPU implementation (the four
  kernels' and FORCE-APTAI's two serving ops): schema, fake shapes,
  dtypes and strides against the real outputs;
* each family's exported graph holds its ops and no inlined plain
  attention or packing: the flash forward once a layer, the fused conv in
  W2V2PR with the fused feature extractor, the packed BiLSTM in FORCE and
  the device beam under ``beam_device``;
* a bundle round trip per family, and for APTAI with the encoder's three
  config variants (``fused_qkv``, ``"bthd"``, non-stable) together (3
  wavs through ``batch=2``: two chunks) against the live predictor on the
  same padded batches, equal, with the float32, int16 and μ-law
  transfers; that variant's checkpoint through ``aptai-torch-export``,
  served by ``build_app`` as the checkpoint is;
* parity with the JAX package: the same weights exported by both
  packages, the same wavs through both bundles (TVs and logits within
  rtol 1e-4 / atol 1e-5, argmax and sequences equal);
* the bundle's contract: overlong input, an empty request, an unknown
  field, ``beam_host`` refused, single-chunk outputs
  that stay tensors, an undeclared device refused, and a load in a fresh
  process that imports no model code.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aptai_tpu.infer import export as jexport
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch.decode.device import beam_decode
from aptai_tpu_torch.infer import (APTAIPredictor, ForceAPTAIPredictor,
                                   W2V2PRPredictor)
from aptai_tpu_torch.infer import export as texport
from aptai_tpu_torch.models import (ForceAPTAI,
                                    force_aptai_state_dict_from_jax,
                                    random_aptai, random_force_aptai,
                                    random_w2v2_pr)
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.ops.fused_conv import fused_conv_ln_gelu_op
from aptai_tpu_torch.ops.lstm import packed_lstm

from _torch_port import (NO_DROP, jax_lstm_one_step_a_loop, one_torch_thread,
                         port_aptai_from_jax, port_w2v2_pr_from_jax,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)

REPO = Path(__file__).resolve().parent.parent
CONVS = dict(conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
STACK = dict(NO_DROP, conv_dim=(16,) * 7, **CONVS)
# the encoder's three config variants together
VARIANTS = dict(STACK, fused_qkv=True, attention_layout="bthd",
                do_stable_layer_norm=False)
# C 128: the mid-stack layers qualify for the fused conv
FUSED = dict(NO_DROP, conv_dim=(128,) * 7, fused_feature_extractor=True,
             **CONVS)
V = 11
BATCH, SECONDS = 2, 1.0  # one whole-second bucket: the live batches' width
SAMPLES = int(SECONDS * 16_000)
FIELDS = {"aptai": ("tvs_pred", "phn_fc_pred"),
          "w2v2_pr": ("phoneme_logits",),
          "force_aptai": ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
                          "phn_seq_lengths")}
FRAME_FIELDS = {"tvs_pred", "phn_fc_pred", "phoneme_logits",
                "pred_frame_phns"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _wavs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(4000 + 4000 * i) * 0.1).astype(np.float32)
            for i in range(n)]


# -- the ops -------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v, dout = (t(2, 2, 9, 64) for _ in range(4))
    lens = torch.tensor([9, 4], dtype=torch.int32)
    out, lse = tatt.flash_fwd_lse(q, k, v, lens)
    _, delta = tatt.flash_bwd_dq(q, k, v, out, lse, dout, lens)
    h = 4
    weights = [t(4 * h, 5), t(4 * h, h), t(4 * h), t(4 * h)] * 2
    log_probs = torch.log_softmax(t(2, 12, 6) * 3, dim=-1)
    return {
        "flash_fwd": (tatt.flash_fwd, (q, k, v, lens)),
        "flash_fwd_lse": (tatt.flash_fwd_lse, (q, k, v, lens)),
        "flash_bwd_dq": (tatt.flash_bwd_dq, (q, k, v, out, lse, dout, lens)),
        "flash_bwd_dkv": (tatt.flash_bwd_dkv,
                          (q, k, v, dout, lse, delta, lens)),
        "fused_conv_ln_gelu": (fused_conv_ln_gelu_op, (
            t(2, 21, 64), t(128, 3, 64), t(128), t(128), t(128), 2, 1e-5)),
        "packed_lstm": (packed_lstm, (
            t(3, 7, 5), torch.tensor([7, 3, 0], dtype=torch.int32), weights,
            True)),
        "beam_decode": (beam_decode, (log_probs, torch.tensor([12, 7]), 0,
                                      10, 50.0, 8)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_opcheck_on_every_op(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_give_the_plain_versions_in_the_kernel_layout():
    """The CPU implementations return the plain versions' values in the
    kernels' output layout: (B, H, T, D) views of (B, T, H, D) buffers."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 9, 64)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([9, 5], dtype=torch.int32)
    out, lse = tatt.flash_fwd_lse(q, k, v, lens)
    want, want_lse = tatt.flash_attention_bhtd_plain(q, k, v, lens,
                                                     return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert out.transpose(1, 2).is_contiguous() and lse.is_contiguous()


# -- bundles -------------------------------------------------------------------

def _port_models():
    """Per family: (JAX params, JAX model, the port's model, method). The
    W2V2PR graph and round trip use ``w2v2_pr_fused`` (its FE fused); the
    JAX parity uses the unfused ``w2v2_pr``."""
    cfg_t, cfg_j = tcfg.tiny_config(**STACK), jcfg.tiny_config(**STACK)
    p_a = random_jax_aptai_params(cfg_t, V, seed=70)
    p_w = random_jax_w2v2_pr_params(cfg_t, seed=71)
    p_f = random_jax_force_params(cfg_j, V, seed=72)

    def force(**kw):
        model = ForceAPTAI(cfg_t, vocab_size=V, **kw)
        model.load_state_dict(force_aptai_state_dict_from_jax(p_f),
                              strict=True)
        return model.eval()

    return {
        "aptai": (p_a, JaxAPTAI(cfg_j, num_phonemes=V),
                  port_aptai_from_jax(cfg_t, p_a, V), "predict"),
        "aptai_variants": (None, None, random_aptai(
            tcfg.tiny_config(**VARIANTS), seed=74, num_phonemes=V).eval(),
            "predict"),
        "w2v2_pr": (p_w, JaxW2V2PR(cfg_j), port_w2v2_pr_from_jax(cfg_t, p_w),
                    "encode"),
        "w2v2_pr_fused": (None, None, random_w2v2_pr(
            tcfg.tiny_config(**FUSED), seed=73).eval(), "encode"),
        "force_aptai": (p_f, JaxForceAPTAI(cfg_j, vocab_size=V), force(),
                        "predict"),
        "force_beam_device": (None, None, force(decode_method="beam_device"),
                              "predict"),
    }


def _family(name):
    return "w2v2_pr" if name.startswith("w2v2") else (
        "force_aptai" if name.startswith("force") else "aptai")


@pytest.fixture(scope="module")
def models():
    return _port_models()


# each bundle's wire encoding: int16 and μ-law are held to the live
# predictor with the same transfer, as float32 is
TRANSFER = {"aptai": "float32", "aptai_variants": "float32",
            "w2v2_pr_fused": "int16",
            "force_aptai": "float32", "force_beam_device": "uint8_mulaw"}


@pytest.fixture(scope="module")
def bundles(models, tmp_path_factory):
    """Each port model's bundle (2 x 1 s, its family's fields, the
    transfer of :data:`TRANSFER`), exported once, and loaded on the
    CPU."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, transfer in TRANSFER.items():
        _, _, model, method = models[name]
        d = texport.save_serving_bundle(
            root / name, model, method=method, batch=BATCH, seconds=SECONDS,
            fields=FIELDS[_family(name)], transfer_dtype=transfer,
            platforms=("cpu",), kind=_family(name))
        out[name] = (d, texport.load_serving_bundle(d, device="cpu"))
    return out


def _graph_ops(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


@pytest.mark.parametrize("name", ["aptai", "aptai_variants", "w2v2_pr_fused",
                                  "force_aptai", "force_beam_device"])
def test_exported_graph_holds_the_ops(bundles, models, name):
    ops = _graph_ops(bundles[name][1].program)
    layers = models[name][2].cfg.num_hidden_layers
    if name.startswith("force"):
        layers = models[name][2].w2v2_pr.cfg.num_hidden_layers
    assert ops.count("aptai_torch.flash_fwd.default") == layers, ops
    # the plain attention's row max and the packing stay out of the graph,
    # and so do torch.export's dtype assertions (one a traced .to())
    assert not any("amax" in o or "pack_padded" in o or "flash_fwd_lse" in o
                   or "_assert_tensor_metadata" in o for o in ops), ops
    assert ops.count("aptai_torch.fused_conv_ln_gelu.default") == (
        6 if name == "w2v2_pr_fused" else 0)
    assert ops.count("aptai_torch.packed_lstm.default") == (
        1 if name.startswith("force") else 0)
    assert ops.count("aptai_torch.beam_decode.default") == (
        1 if name == "force_beam_device" else 0)


def _live_entry(model, method, transfer):
    kw = dict(device="cpu", transfer_dtype=transfer)
    if method == "encode":
        return W2V2PRPredictor(model, **kw).encode_batch
    cls = APTAIPredictor if type(model).__name__ == "APTAI" else \
        ForceAPTAIPredictor
    return cls(model, **kw).predict_batch


@pytest.mark.parametrize("name", ["aptai", "aptai_variants", "w2v2_pr_fused",
                                  "force_aptai", "force_beam_device"])
def test_bundle_round_trip_matches_live_predictor(bundles, models, name):
    _, bundle = bundles[name]
    wavs = _wavs()
    got = bundle.predict_batch(wavs)  # two chunks: host arrays
    fields = FIELDS[_family(name)]
    assert set(got) == set(fields) | {"frame_lengths"}
    assert all(isinstance(v, np.ndarray) and v.shape[0] == 3
               for v in got.values())
    # the live predictor on the bundle's padded batches: the same shapes
    live = _live_entry(models[name][2], models[name][3], TRANSFER[name])
    pad = np.zeros(SAMPLES, np.float32)
    want = [live(wavs[:2], fields=fields),
            live([wavs[2], pad], fields=fields)]
    for k in got:
        ref = np.concatenate([want[0][k].numpy(), want[1][k][:1].numpy()])
        np.testing.assert_array_equal(got[k], ref, err_msg=k)


@pytest.mark.parametrize("name", ["aptai", "w2v2_pr", "force_aptai"])
def test_bundle_matches_the_jax_packages_bundle(models, bundles, name,
                                                tmp_path, monkeypatch):
    """TVs and logits within rtol 1e-4 / atol 1e-5 (FORCE's TVs, after the
    BiLSTM, within 1e-4 of their largest magnitude, the gate of
    ``test_torch_force.py``); argmax, sequences and lengths equal."""
    jax_lstm_one_step_a_loop(monkeypatch)
    params, jmodel, tmodel, method = models[name]
    wavs = _wavs(seed=3)
    kw = dict(method=method, batch=BATCH, seconds=SECONDS,
              fields=FIELDS[name])
    jbundle = jexport.load_serving_bundle(jexport.save_serving_bundle(
        tmp_path / "jax", jmodel, params, platforms=("cpu",), **kw))
    want = {k: np.asarray(v) for k, v in jbundle.predict_batch(wavs).items()}
    tbundle = bundles[name][1] if name in bundles else \
        texport.load_serving_bundle(texport.save_serving_bundle(
            tmp_path / "port", tmodel, platforms=("cpu",), **kw),
            device="cpu")
    got = tbundle.predict_batch(wavs)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["frame_lengths"], want["frame_lengths"])
    for i, n in enumerate(want["frame_lengths"]):
        for k in got:
            g, w = got[k][i], want[k][i]
            if k in FRAME_FIELDS:  # valid frames
                g, w = g[:n], w[:n]
            if k == "tvs_pred" and name == "force_aptai":
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
            elif k in ("tvs_pred", "phoneme_logits"):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_variant_checkpoint_exports_and_serves(models, tmp_path, capsys):
    """A port checkpoint of the ``fused_qkv`` + ``"bthd"`` + non-stable
    APTAI through ``aptai-torch-export``: ``build_app`` over the bundle
    answers ``/v1/predict`` as ``build_app`` over the checkpoint does (the
    same padded batch)."""
    from aptai_tpu_torch.infer import serve as tserve
    from aptai_tpu_torch.train import checkpoints as tckpt

    model = models["aptai_variants"][2]
    ckpt = tmp_path / "run"
    tckpt.CheckpointManager(ckpt, "m").update(
        0, {"m": 1.0}, model.state_dict(), model_cfg={
            "backbone": dataclasses.asdict(model.cfg),
            "vocab": {f"p{i}": i for i in range(V)}, "kind": "aptai"})
    out = tmp_path / "bundle"
    assert texport.main([str(ckpt), str(out), "--batch", "2", "--seconds",
                         "1", "--platforms", "cpu"]) == 0
    capsys.readouterr()
    wav = _wavs(1, seed=4)[0].tobytes()
    answers = []
    for path in (ckpt, out):
        app = tserve.build_app(str(path), device="cpu", max_batch_size=2,
                               warmup=False, streaming=False)
        try:
            answers.append(app.handle("POST", "/v1/predict", {}, wav))
        finally:
            app.batcher.stop()
    assert answers[0][0] == 200 and answers[1] == answers[0]


# -- the bundle's contract -----------------------------------------------------

def test_bundle_refuses_overlong_and_empty_requests(bundles):
    bundle = bundles["aptai"][1]
    with pytest.raises(ValueError, match="re-export"):
        bundle.predict_batch([np.zeros(SAMPLES + 1, np.float32)])
    with pytest.raises(ValueError, match="at least one"):
        bundle.predict_batch([])


def test_single_chunk_outputs_stay_tensors(bundles):
    out = bundles["aptai"][1].predict_batch(_wavs(1))
    assert all(isinstance(v, torch.Tensor) and v.shape[0] == 1
               for v in out.values()), {k: type(v) for k, v in out.items()}


def test_export_refusals(models, tmp_path):
    _, _, model, _ = models["aptai"]
    with pytest.raises(ValueError, match="unknown output field"):
        texport.save_serving_bundle(tmp_path / "bad", model, batch=1,
                                    seconds=0.25, fields=("nope",),
                                    platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms"):
        texport.save_serving_bundle(tmp_path / "tpu", model, batch=1,
                                    seconds=0.25, platforms=("tpu",))
    beam = random_force_aptai(tcfg.tiny_config(**STACK), seed=0,
                              vocab_size=V, decode_method="beam_host")
    with pytest.raises(ValueError, match="beam_host"):
        texport.save_serving_bundle(tmp_path / "beam", beam, batch=1,
                                    seconds=0.25, platforms=("cpu",))
    assert not (tmp_path / "beam").exists()


def test_bundle_loads_only_on_a_declared_device(bundles, monkeypatch):
    d = bundles["aptai"][0]
    assert texport.is_bundle(d) and not texport.is_bundle(d.parent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_serving_bundle(d)  # cuda unless named


_FRESH_LOAD = """
import sys
import numpy as np
from aptai_tpu_torch.infer.export import load_serving_bundle
b = load_serving_bundle(sys.argv[1], device="cpu")
out = b.predict_batch([np.zeros(4000, np.float32)])
print("FIELDS", sorted(out))
print("MODELS", sorted(m for m in sys.modules if m.startswith(
    ("aptai_tpu_torch.models", "aptai_tpu_torch.train",
     "aptai_tpu_torch.infer.loader", "aptai_tpu_torch.infer.api", "jax"))))
"""


def test_bundle_loads_without_the_model_code(bundles):
    """A fresh process loads and runs a FORCE bundle (every serving op)
    importing the ops' modules only: no model, trainer or loader module."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run(
        [sys.executable, "-c", _FRESH_LOAD,
         str(bundles["force_beam_device"][0])], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "MODELS []" in res.stdout, res.stdout
    assert "'pred_ctc_phn_seq'" in res.stdout, res.stdout
