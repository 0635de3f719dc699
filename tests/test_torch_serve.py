"""aptai_tpu_torch's serving front end (``infer/serve.py``) against the JAX
package's, float32 on the CPU, with the same weights (the wire formats
are in ``test_torch_serve_wire.py``):

* ``ServingApp.handle`` on the same requests (every endpoint, the wire
  encodings, ``fields``, both formats, and the errors: 400, 404, 405):
  the same statuses, content types, error messages and keys, numbers
  within 1e-4 of their largest magnitude and integers equal; the W2V2PR
  family's decoded sequences equal;
* the stdlib server over a socket returns what ``handle`` returns, and a
  hostile Content-Length gets the JAX server's 413 before the body is read
  (a malformed one its 400);
* a small seeded fuzz of garbage requests over raw sockets leaves both of
  the port's transports answering ``/healthz``;
* ``build_app`` over a checkpoint on the CPU (a ``beam_host`` FORCE model
  serves with ``/v1/stream`` off); with ``quant="w8a8"`` ``/v1/predict``
  answers as the quantized predictor does and ``/v1/stream`` serves the
  same model; a JAX serving bundle raises, with a message naming
  ``aptai-torch-export``;
* ``aptai-torch-export`` over a checkpoint of either package, then
  ``build_app`` over the bundle: ``/v1/predict`` as the live app answers,
  the bundle's cap enforced with a 400, no ``/v1/stream``; a bundle without
  a family and a ``beam_host`` checkpoint refused.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
from _http_client import (body_json, healthy, raw_exchange, request,
                          status_line)

from aptai_tpu.infer import StreamingAPTAI as JaxStreamingAPTAI
from aptai_tpu.infer import StreamingW2V2PR as JaxStreamingW2V2PR
from aptai_tpu.infer import serve as jserve
from aptai_tpu.infer.api import APTAIPredictor as JaxAPTAIPredictor
from aptai_tpu.infer.api import W2V2PRPredictor as JaxW2V2PRPredictor
from aptai_tpu.infer.api import quantize_transfer
from aptai_tpu.infer.export import is_bundle as jax_is_bundle
from aptai_tpu.infer.server import MicroBatcher as JaxMicroBatcher
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu_torch.infer import (APTAIPredictor, MicroBatcher,
                                   StreamingAPTAI, StreamingW2V2PR,
                                   W2V2PRPredictor)
from aptai_tpu_torch.infer import native_transport
from aptai_tpu_torch.infer import serve as tserve
from aptai_tpu_torch.infer.loader import load_predictor
from aptai_tpu_torch.models import configs as tcfg

from _torch_port import (NO_DROP, one_torch_thread, port_aptai_from_jax,
                         port_w2v2_pr_from_jax, random_jax_aptai_params,
                         random_jax_force_params, random_jax_w2v2_pr_params)


STACK = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
VOCAB = {"(blank)": 0, "(...)": 1,
         **{c: i + 2 for i, c in enumerate("abcdefghi")}}
STREAM = dict(chunk_seconds=1.0, overlap_seconds=0.25, chunk_batch=2)
APP = dict(max_seconds=1.0, max_stream_seconds=4.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _wav(n, seed):
    return (np.random.default_rng(seed).standard_normal(n)
            .astype(np.float32) * 0.1)


def _apps(kind):
    """The JAX app and the port's over the same weights, each with its
    batcher running and its streamer."""
    cfg_t = tcfg.tiny_config(**STACK)
    cfg_j = jcfg.tiny_config(**STACK)
    if kind == "aptai":
        p = random_jax_aptai_params(cfg_t, V, seed=60)
        jpred = JaxAPTAIPredictor(JaxAPTAI(cfg_j, num_phonemes=V), p)
        jstream = JaxStreamingAPTAI(JaxAPTAI(cfg_j, num_phonemes=V), p,
                                    **STREAM)
        tmodel = port_aptai_from_jax(cfg_t, p, V)
        tpred = APTAIPredictor(tmodel, device="cpu")
        tstream = StreamingAPTAI(tpred.model, device="cpu", **STREAM)
        j_entry, t_entry = jpred.predict_batch, tpred.predict_batch
    else:
        p = random_jax_w2v2_pr_params(cfg_t, seed=61)
        jpred = JaxW2V2PRPredictor(JaxW2V2PR(cfg_j), p, VOCAB)
        jstream = JaxStreamingW2V2PR(JaxW2V2PR(cfg_j), p, **STREAM)
        tpred = W2V2PRPredictor(port_w2v2_pr_from_jax(cfg_t, p), VOCAB,
                                device="cpu")
        tstream = StreamingW2V2PR(tpred.model, device="cpu", **STREAM)
        j_entry, t_entry = jpred.encode_batch, tpred.encode_batch
    fields = tserve.KIND_FIELDS[kind]
    jb = JaxMicroBatcher(j_entry, max_batch_size=2, max_wait_ms=5.0,
                         fields=fields).start()
    tb = MicroBatcher(t_entry, max_batch_size=2, max_wait_ms=5.0,
                      fields=fields).start()
    vocab = VOCAB if kind == "w2v2_pr" else None
    return (jserve.ServingApp(jb, kind, vocab=vocab, streamer=jstream, **APP),
            tserve.ServingApp(tb, kind, vocab=vocab, streamer=tstream, **APP))


@pytest.fixture(scope="module")
def apps():
    out = {kind: _apps(kind) for kind in ("aptai", "w2v2_pr")}
    yield out
    for pair in out.values():
        for app in pair:
            app.batcher.stop()


# -- ServingApp.handle --------------------------------------------------------

def _close_payloads(got, want, path=""):
    """Same keys, strings and integers; float arrays within 1e-4 of their
    largest magnitude."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close_payloads(got[k], want[k], f"{path}/{k}")
        return
    w, g = np.asarray(want), np.asarray(got)
    if w.dtype.kind == "f":
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(
            np.abs(w).max(initial=0.0), 1e-6), err_msg=path)
    else:
        assert g.tolist() == w.tolist(), path


def _decode(status, data, ctype):
    if ctype == "application/x-aptai-bin":
        return tserve.decode_binary(data)
    return json.loads(data)


def _requests(kind):
    wav = _wav(9000, 64)
    long = _wav(40_000, 65)
    i16 = quantize_transfer(wav, "int16").tobytes()
    frames_key = "phn_fc_pred" if kind == "aptai" else "phn_seq_idx"
    return {
        "healthz": ("GET", "/healthz", {}, b""),
        "get_unknown": ("GET", "/nope", {}, b""),
        "put": ("PUT", "/v1/predict", {}, b""),
        "post_unknown": ("POST", "/v1/oops", {}, b""),
        "predict": ("POST", "/v1/predict", {}, wav.tobytes()),
        "predict_int16_binary": ("POST", "/v1/predict?format=binary",
                                 {"X-Audio-Encoding": "int16"}, i16),
        "predict_mulaw_header_binary": (
            "POST", "/v1/predict", {"X-Audio-Encoding": "uint8_mulaw",
                                    "X-Response-Format": "binary"},
            quantize_transfer(wav, "uint8_mulaw").tobytes()),
        "predict_json": ("POST", "/v1/predict",
                         {"Content-Type": "application/json"},
                         json.dumps({"audio": wav.tolist()}).encode()),
        "predict_fields": ("POST", f"/v1/predict?fields={frames_key}", {},
                           wav.tobytes()),
        "predict_bad_field": ("POST", "/v1/predict?fields=nope", {},
                              wav.tobytes()),
        "predict_bad_format": ("POST", "/v1/predict?format=xml", {},
                               wav.tobytes()),
        "predict_too_long": ("POST", "/v1/predict", {}, long.tobytes()),
        "predict_empty": ("POST", "/v1/predict", {}, b""),
        "stream": ("POST", "/v1/stream", {}, long.tobytes()),
        "stream_binary_int16": ("POST", "/v1/stream?format=binary",
                                {"X-Audio-Encoding": "int16"},
                                quantize_transfer(long, "int16").tobytes()),
        "stream_too_long": ("POST", "/v1/stream", {},
                            np.zeros(5 * 16_000, np.float32).tobytes()),
        "metrics": ("GET", "/metrics", {}, b""),
    }


@pytest.mark.parametrize("kind", ["aptai", "w2v2_pr"])
def test_handle_matches_jax(apps, kind):
    japp, tapp = apps[kind]
    for name, (method, target, headers, body) in _requests(kind).items():
        want = japp.handle(method, target, headers, body)
        got = tapp.handle(method, target, headers, body)
        assert got[0] == want[0] and got[2] == want[2], (name, got[0],
                                                         want[0])
        g, w = _decode(*got), _decode(*want)
        if name == "metrics":  # counters; latencies are the hosts' own
            assert set(g) == set(w)
            for k in ("requests_total", "errors_total",
                      "stream_requests_total", "audio_seconds_total",
                      "stream_audio_seconds_total", "latency_window"):
                assert g[k] == w[k], k
            continue
        if got[0] >= 400 or name == "healthz":
            assert g == w, name
            continue
        _close_payloads(g, w, name)


# -- the stdlib server --------------------------------------------------------

@pytest.fixture(scope="module")
def servers(apps):
    """The port's APTAI app behind its stdlib server, and the JAX app
    behind the JAX one."""
    out = []
    for app, make in zip(apps["aptai"], (jserve.make_server,
                                         tserve.make_server)):
        srv = make(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append(srv)
    yield [s.server_address[1] for s in out]
    for s in out:
        s.shutdown()
        s.server_close()


def test_stdlib_server_returns_what_handle_returns(apps, servers):
    _, tapp = apps["aptai"]
    _, tport = servers
    reqs = _requests("aptai")
    for name in ("healthz", "predict", "predict_int16_binary",
                 "predict_bad_field", "stream_binary_int16"):
        method, target, headers, body = reqs[name]
        want = tapp.handle(method, target, headers, body)
        got = request(tport, method, target, body or None, headers)
        assert got == want, name


def test_hostile_content_length_rejected_as_jax_does(apps, servers):
    jport, tport = servers
    answers = []
    for app, port in zip(apps["aptai"], servers):
        old, app.max_body_bytes = app.max_body_bytes, 1024
        try:
            big = raw_exchange(port, b"POST /v1/predict HTTP/1.1\r\nHost: x"
                               b"\r\nContent-Length: 4096\r\n\r\n"
                               + b"\x00" * 4096)
            bad = raw_exchange(port, b"POST /v1/predict HTTP/1.1\r\nHost: x"
                               b"\r\nContent-Length: zzz\r\n\r\n")
        finally:
            app.max_body_bytes = old
        answers.append([(status_line(d).split(" ", 1)[1], body_json(d),
                         b"Connection: close" in d) for d in (big, bad)])
    assert answers[0] == answers[1]
    assert answers[1][0] == ("413 Request Entity Too Large",
                             {"error": "request body too large"}, True)
    assert answers[1][1][:2] == ("400 Bad Request",
                                 {"error": "bad Content-Length"})


# -- transport fuzz -----------------------------------------------------------

def _garbage_cases(seed=0):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(4):
        junk = bytes(rng.integers(32, 127, int(rng.integers(1, 200)))
                     .astype(np.uint8))
        cases.append(junk + b"\r\n\r\n")
    for _ in range(4):
        junk = bytes(rng.integers(0, 256, int(rng.integers(1, 120)))
                     .astype(np.uint8))
        cases.append(junk.replace(b"\r", b"").replace(b"\n", b"")
                     + b"\r\n\r\n")
    cases += [
        b"FROB /v1/predict HTTP/1.1\r\nHost: x\r\n\r\n",
        b"GET \x00\x01 HTTP/1.1\r\n\r\n",
        b"POST /v1/predict HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
        b"POST /v1/predict HTTP/1.1\r\nContent-Length: 7\r\n"
        b"X-Audio-Encoding: nope\r\n\r\n1234567",
        b"POST /v1/predict HTTP/1.1\r\nContent-Length: 5\r\n\r\nabcde",
        b"POST /v1/predict?fields=;;;drop HTTP/1.1\r\n"
        b"Content-Length: 4\r\n\r\n\x00\x00\x80\x3f",
        b"POST /v1/stream HTTP/1.1\r\nContent-Length: 2\r\n\r\nhi",
        b"GET /metrics HTTP/1.0\r\n\r\n",
        b"POST /v1/predict HTTP/1.1\r\n" + b"X-A: b\r\n" * 50
        + b"Content-Length: 4\r\n\r\nabcd",
    ]
    return cases


def test_garbage_requests_never_kill_either_transport(apps, servers):
    _, tapp = apps["aptai"]
    ports = [("python", servers[1], None)]
    native = native_transport.make_native_server(tapp, "127.0.0.1", 0)
    ports.append(("native", native.port, native))
    try:
        for name, port, _ in ports:
            for i, payload in enumerate(_garbage_cases()):
                raw_exchange(port, payload, timeout=3)
                assert healthy(port), (name, i, payload[:60])
    finally:
        native.shutdown()


# -- build_app and main -------------------------------------------------------

def _write_checkpoint(root, kind, params, **cfg):
    backbone = jcfg.tiny_config(**STACK)
    jckpt.CheckpointManager(root, "m").update(0, {"m": 1.0}, params,
                                              model_cfg={
        "backbone": dataclasses.asdict(backbone), "vocab": VOCAB,
        "kind": kind, **cfg})
    return str(root)


def test_build_app_over_checkpoints(tmp_path, monkeypatch):
    cfg_t = tcfg.tiny_config(**STACK)
    aptai = _write_checkpoint(tmp_path / "aptai", "aptai",
                              random_jax_aptai_params(cfg_t, V, 66))
    app = tserve.build_app(aptai, device="cpu", max_batch_size=2,
                           warmup_seconds=0.5, chunk_seconds=1.0,
                           overlap_seconds=0.25, chunk_batch=2)
    try:
        assert app.streamer.model is app.batcher.predict_batch.__self__.model
        status, data, _ = app.handle("POST", "/v1/stream", {},
                                     _wav(20_000, 67).tobytes())
        assert status == 200 and json.loads(data)["frames"] > 0
        assert app.health()[1]["streaming"] is True
    finally:
        app.batcher.stop()

    force = _write_checkpoint(
        tmp_path / "force", "force_aptai", random_jax_force_params(
            jcfg.tiny_config(**STACK), len(VOCAB), 68),
        decode_method="beam_host")
    app = tserve.build_app(force, device="cpu", max_batch_size=2,
                           warmup=False)
    try:
        assert app.streamer is None
        status, data, _ = app.handle("POST", "/v1/stream", {}, b"\x00" * 64)
        assert status == 404
        status, data, _ = app.handle("POST", "/v1/predict", {},
                                     _wav(8000, 69).tobytes())
        assert status == 200 and "pred_ctc_phn_seq" in json.loads(data)
    finally:
        app.batcher.stop()

    # quantized: /v1/predict answers as the quantized predictor does, and
    # the streamer serves the same quantized model
    app = tserve.build_app(aptai, device="cpu", quant="w8a8",
                           max_batch_size=2, warmup=False, **STREAM)
    direct = tserve.ServingApp(MicroBatcher(
        load_predictor(aptai, device="cpu", quant="w8a8").predict_batch,
        max_batch_size=2, fields=tserve.KIND_FIELDS["aptai"]).start(),
        "aptai", vocab=VOCAB)
    try:
        model = app.batcher.predict_batch.__self__.model
        assert app.streamer.model is model and model.cfg.quant == "w8a8"
        body = _wav(12_000, 70).tobytes()
        got = app.handle("POST", "/v1/predict", {}, body)
        assert got[0] == 200
        assert got == direct.handle("POST", "/v1/predict", {}, body)
        status, data, _ = app.handle("POST", "/v1/stream", {},
                                     _wav(20_000, 71).tobytes())
        assert status == 200 and json.loads(data)["frames"] > 0
    finally:
        app.batcher.stop()
        direct.batcher.stop()
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    (bundle / "forward.stablehlo").write_bytes(b"")
    (bundle / "meta.json").write_text("{}")
    for path, want in ((bundle, True), (aptai, False)):
        assert tserve.is_bundle(path) is jax_is_bundle(path) is want
    with pytest.raises(ValueError, match="aptai-torch-export"):
        tserve.build_app(str(bundle), device="cpu")
    assert tserve.main(["--checkpoint", str(bundle), "--cpu"]) == 2
    parser = tserve.build_parser()
    args = parser.parse_args(["--checkpoint", "x", "--chunk_batch", "8",
                              "--dtype", "float32"])
    assert tserve.bundle_ignored_flags(args, parser) == [
        "--dtype", "--chunk_batch"]


def test_export_cli_then_serve_bundle(tmp_path, capsys):
    """The deployment path: a checkpoint of either package →
    ``aptai-torch-export`` → ``build_app`` over the bundle, on the CPU:
    ``/v1/predict`` answers as the live app over the checkpoint does, an
    over-cap request gets the JAX bundle app's 400, ``/v1/stream`` is off
    and ``/healthz`` names the bundle; a bundle with no family and a
    ``beam_host`` checkpoint are refused."""
    from aptai_tpu_torch.infer import export as texport
    from aptai_tpu_torch.train import checkpoints as tckpt

    cfg_t = tcfg.tiny_config(**STACK)
    params = random_jax_aptai_params(cfg_t, V, 74)
    jax_ckpt = _write_checkpoint(tmp_path / "jax_run", "aptai", params)
    port_ckpt = tmp_path / "port_run"
    tckpt.CheckpointManager(port_ckpt, "m").update(
        0, {"m": 1.0}, port_aptai_from_jax(cfg_t, params, V).state_dict(),
        model_cfg={"backbone": dataclasses.asdict(cfg_t), "vocab": VOCAB,
                   "kind": "aptai"})
    live = tserve.build_app(jax_ckpt, device="cpu", max_batch_size=2,
                            warmup=False, streaming=False)
    wav = _wav(9000, 75)
    want = live.handle("POST", "/v1/predict", {}, wav.tobytes())
    live.batcher.stop()
    for i, ckpt in enumerate((jax_ckpt, str(port_ckpt))):
        out = tmp_path / f"bundle{i}"
        assert texport.main([ckpt, str(out), "--batch", "2", "--seconds",
                             "1", "--platforms", "cpu"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["kind"] == "aptai" and line["bytes"] > 0
        app = tserve.build_app(str(out), device="cpu", warmup=i == 0)
        try:
            assert app.streamer is None and app.max_seconds == 1.0
            got = app.handle("POST", "/v1/predict", {}, wav.tobytes())
            assert got[0] == want[0] == 200 and got[2] == want[2]
            assert got[1] == want[1]  # the same padded batch: equal
            status, body, _ = app.handle(
                "POST", "/v1/predict", {},
                np.zeros(20_000, np.float32).tobytes())
            assert status == 400 and "serving cap" in json.loads(body)["error"]
            assert app.handle("POST", "/v1/stream", {}, wav.tobytes())[0] \
                == 404
            health = app.health()[1]
            assert health["bundle"] == str(out)
            assert health["platforms"] == ["cpu"]
        finally:
            app.batcher.stop()

    nokind = texport.save_serving_bundle(
        tmp_path / "nokind", port_aptai_from_jax(cfg_t, params, V), batch=1,
        seconds=0.25, platforms=("cpu",))
    with pytest.raises(ValueError, match="aptai-torch-export"):
        tserve.build_app(str(nokind), device="cpu")

    force = _write_checkpoint(
        tmp_path / "force", "force_aptai", random_jax_force_params(
            jcfg.tiny_config(**STACK), len(VOCAB), 76),
        decode_method="beam_host")
    assert texport.main([force, str(tmp_path / "fb"), "--platforms",
                         "cpu"]) == 2
    assert "beam_host" in capsys.readouterr().err


@pytest.mark.parametrize("family", ["w2v2_pr", "force_greedy",
                                    "force_beam_device"])
def test_export_cli_over_each_family(tmp_path, capsys, family):
    """``aptai-torch-export`` over a JAX W2V2PR checkpoint and FORCE ones
    (greedy and ``beam_device``): the family's fields and serving method,
    its ops in the graph, and the bundle's outputs equal to the live
    predictor's over the checkpoint on the same padded batch."""
    import torch

    from aptai_tpu_torch.infer import export as texport
    from aptai_tpu_torch.infer.loader import load_predictor

    cfg_j = jcfg.tiny_config(**STACK)
    if family == "w2v2_pr":
        ckpt = _write_checkpoint(tmp_path / "run", "w2v2_pr",
                                 random_jax_w2v2_pr_params(
                                     tcfg.tiny_config(**STACK), 77))
    else:
        ckpt = _write_checkpoint(
            tmp_path / "run", "force_aptai",
            random_jax_force_params(cfg_j, len(VOCAB), 78),
            decode_method=family.split("_", 1)[1])
    out = tmp_path / "bundle"
    assert texport.main([ckpt, str(out), "--batch", "2", "--seconds", "1",
                         "--platforms", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kind = "w2v2_pr" if family == "w2v2_pr" else "force_aptai"
    assert line["kind"] == kind
    assert line["fields"] == list(tserve.KIND_FIELDS[kind])
    bundle = texport.load_serving_bundle(out, device="cpu")
    assert bundle.meta["method"] == ("encode" if kind == "w2v2_pr"
                                     else "predict")
    ops = {str(n.target) for n in bundle.program.graph.nodes}
    assert "aptai_torch.flash_fwd.default" in ops
    assert (("aptai_torch.beam_decode.default" in ops)
            == (family == "force_beam_device"))
    wavs = [_wav(9000, 79), np.zeros(16_000, np.float32)]
    got = bundle.predict_batch(wavs)
    pred = load_predictor(ckpt, device="cpu")
    entry = pred.encode_batch if kind == "w2v2_pr" else pred.predict_batch
    want = entry(wavs, fields=tserve.KIND_FIELDS[kind])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
