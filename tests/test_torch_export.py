"""aptai_tpu_torch's serving bundles (``infer/export.py``), float32 on the
CPU:

* each family's exported graph holds its ops and no inlined plain
  attention or packing: the flash forward once a layer, the fused conv in
  W2V2PR with the fused feature extractor, the packed BiLSTM in FORCE and
  the device beam under ``beam_device``;
* a bundle round trip per family, and for APTAI with the encoder's three
  config variants (``fused_qkv``, ``"bthd"``, non-stable) together (3
  wavs through ``batch=2``: two chunks) against the live predictor on the
  same padded batches, equal, with the float32, int16 and μ-law
  transfers;
* the checkpoint of APTAI with the encoder's three config variants
  through ``aptai-torch-export``, served by ``build_app`` as the
  checkpoint is;
* overlong input, an empty request and an unknown field refused, and
  single-chunk outputs that stay tensors.

The ops and a bundle's load in a fresh process are in
``test_torch_export_ops.py``; the parity with the JAX package's bundles
and the export's refusals in ``test_torch_export_contract.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aptai_tpu_torch.decode.device import beam_decode
from aptai_tpu_torch.infer import (APTAIPredictor, ForceAPTAIPredictor,
                                   W2V2PRPredictor)
from aptai_tpu_torch.infer import export as texport
from aptai_tpu_torch.ops.lstm import packed_lstm

from _torch_port import one_torch_thread
from _torch_export_bundles import (FIELDS, SAMPLES, TRANSFER, V, _family,
                                   _wavs, bundles, models)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


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


# -- the bundle's contract -----------------------------------------------------

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
