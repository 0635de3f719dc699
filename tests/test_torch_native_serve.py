"""aptai_tpu_torch's native (C++ epoll) transport, on the CPU: g++ builds
``native/http_server.cpp`` alone into the port's build directory, and one
``ServingApp`` (a tiny float32 APTAI with its streamer) sits behind both of
the port's transports, so any difference is the transport's:

* the fast lane (octet-stream ``/v1/predict``) answers byte for byte what
  the Python transport answers, for each wire encoding and both formats,
  with ``fields``, counting the request as the Python transport does;
* the slow lane (GET endpoints, JSON bodies, ``/v1/stream``, errors)
  routes through ``ServingApp.handle``: the same statuses and messages;
* the transport's own errors are those of the JAX transports (its tests
  pin them): 413 for a Content-Length over the body cap, answered before
  the body is read, 431 for a header block over 64 KiB, 400 for a
  malformed Content-Length; a request past ``request_timeout_s`` gets 503;
* keep-alive, and the library's build (a file keyed by source and flags).
"""

import http.client
import json
import threading

import numpy as np
import pytest

from aptai_tpu.infer.api import quantize_transfer
from aptai_tpu_torch.infer import (APTAIPredictor, MicroBatcher,
                                   StreamingAPTAI)
from aptai_tpu_torch.infer import native_transport as nt
from aptai_tpu_torch.infer.serve import ServingApp, decode_binary, make_server
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai

from _http_client import (TIMEOUT, body_json, healthy, raw_exchange, request,
                          status_line)
from _torch_port import NO_DROP, one_torch_thread

STACK = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def servers():
    """(native port, Python port, app): one app behind both transports."""
    pred = APTAIPredictor(random_aptai(tcfg.tiny_config(**STACK), seed=70,
                                       num_phonemes=11), device="cpu")
    batcher = MicroBatcher(pred.predict_batch, max_batch_size=2,
                           max_wait_ms=5.0,
                           fields=("tvs_pred", "phn_fc_pred")).start()
    streamer = StreamingAPTAI(pred.model, chunk_seconds=1.0,
                              overlap_seconds=0.25, chunk_batch=2,
                              device="cpu")
    app = ServingApp(batcher, "aptai", max_seconds=2.0, streamer=streamer,
                     max_stream_seconds=10.0)
    native = nt.make_native_server(app, "127.0.0.1", 0, fast_max_seconds=1.5)
    pysrv = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=pysrv.serve_forever, daemon=True).start()
    yield native.port, pysrv.server_address[1], app
    native.shutdown()
    pysrv.shutdown()
    pysrv.server_close()
    batcher.stop()


def _wav(n, seed):
    return (np.random.default_rng(seed).standard_normal(n)
            .astype(np.float32) * 0.1)


def test_library_builds_alone_keyed_by_source_and_flags():
    assert nt.native_transport_available(), nt.build_error()
    path = nt.library_path()
    assert path.exists() and path.parent == nt.BUILD_DIR
    assert path.name.startswith("libaptai_http-")
    assert "-pthread" in nt.CXX_FLAGS


@pytest.mark.parametrize("wire", ["float32", "int16", "uint8_mulaw"])
@pytest.mark.parametrize("fmt", ["binary", "json"])
def test_fast_lane_is_byte_identical_to_python(servers, wire, fmt):
    nport, pport, app = servers
    body = quantize_transfer(_wav(4000, 71), wire).tobytes()
    hdr = {"X-Audio-Encoding": wire}
    path = f"/v1/predict?format={fmt}"
    answers = []
    for port in (nport, pport):
        with app._stats_lock:
            before = dict(app._stats)
        answers.append(request(port, "POST", path, body, hdr))
        with app._stats_lock:
            after = dict(app._stats)
        assert after["requests_total"] == before["requests_total"] + 1
        assert after["audio_seconds_total"] == pytest.approx(
            before["audio_seconds_total"] + 4000 / 16_000)
    assert answers[0] == answers[1]
    status, raw, ctype = answers[0]
    assert status == 200
    payload = decode_binary(raw) if fmt == "binary" else json.loads(raw)
    assert payload["frames"] == len(payload["phn_fc_pred"]) > 0


def test_fast_lane_fields_and_header_format(servers):
    nport, pport, _ = servers
    wav = _wav(3000, 72).tobytes()
    for path, hdr in (("/v1/predict?fields=tvs_pred", {}),
                      ("/v1/predict?informat=x",
                       {"X-Response-Format": "binary"}),
                      ("/v1/predict?format=bogus", {}),
                      ("/v1/predict?fields=nope", {})):
        got = request(nport, "POST", path, wav, hdr)
        assert got == request(pport, "POST", path, wav, hdr), path
    assert set(json.loads(request(nport, "POST",
                                  "/v1/predict?fields=tvs_pred", wav)[1])
               ) == {"frames", "tvs_pred"}


def test_slow_lane_matches_python(servers):
    nport, pport, _ = servers
    wav = _wav(2500, 73)
    cases = [
        ("GET", "/healthz", None, {}),
        ("GET", "/nope", None, {}),
        ("POST", "/v1/oops", b"", {}),
        ("POST", "/v1/predict", json.dumps({"audio": wav.tolist()}).encode(),
         {"Content-Type": "application/json"}),
        ("POST", "/v1/predict", json.dumps({"audio": wav.tolist()}).encode(),
         {"Content-Type": "application/json", "X-Pad": "a" * 40_000}),
        ("POST", "/v1/predict", np.zeros(16_000 * 3, np.float32).tobytes(),
         {}),
        ("POST", "/v1/predict", b"\x00" * 64, {"X-Audio-Encoding": "pcm24"}),
        ("POST", "/v1/predict", b"", {}),
        ("POST", "/v1/stream?format=binary", _wav(16_000 * 3, 74).tobytes(),
         {}),
    ]
    for method, path, body, hdr in cases:
        got = request(nport, method, path, body, hdr)
        assert got == request(pport, method, path, body, hdr), (method, path)
    status, raw, _ = request(nport, "POST", "/v1/stream?format=binary",
                             _wav(16_000 * 3, 74).tobytes())
    payload = decode_binary(raw)
    assert status == 200 and payload["frames"] == len(payload["phn_fc_pred"])
    status, raw, _ = request(nport, "GET", "/metrics")
    assert status == 200 and json.loads(raw)["requests_total"] > 0


def test_transport_errors_as_the_jax_transports_give_them(servers):
    nport, _, app = servers
    big = nt.make_native_server(app, "127.0.0.1", 0, max_body_bytes=1024)
    try:
        d = raw_exchange(big.port, b"POST /v1/predict HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: 4096\r\n\r\n")  # body never sent
        assert " 413 " in status_line(d)
        assert body_json(d) == {"error": "request body too large"}
        assert healthy(big.port)
    finally:
        big.shutdown()
    d = raw_exchange(nport, b"GET /healthz HTTP/1.1\r\nHost: x\r\nX-Pad: "
                     + b"a" * 70_000 + b"\r\n\r\n")
    assert " 431 " in status_line(d)
    d = raw_exchange(nport, b"POST /v1/predict HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: zzz\r\n\r\n")
    assert " 400 " in status_line(d)
    assert healthy(nport)


def test_fast_lane_sheds_past_the_request_timeout(servers):
    nport, _, app = servers
    old, app.request_timeout_s = app.request_timeout_s, 1e-9
    try:
        status, raw, _ = request(nport, "POST", "/v1/predict",
                                 _wav(2000, 75).tobytes())
    finally:
        app.request_timeout_s = old
    assert status == 503 and "timed out" in json.loads(raw)["error"]


def test_keep_alive_reuses_one_connection(servers):
    nport, _, _ = servers
    conn = http.client.HTTPConnection("127.0.0.1", nport, timeout=TIMEOUT)
    try:
        frames = []
        for _ in range(3):
            conn.request("POST", "/v1/predict",
                         body=_wav(2000, 76).tobytes())
            r = conn.getresponse()
            assert r.status == 200
            assert r.getheader("Connection") == "keep-alive"
            frames.append(json.loads(r.read())["frames"])
    finally:
        conn.close()
    assert frames[0] == frames[1] == frames[2] > 0
