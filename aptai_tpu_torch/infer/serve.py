"""HTTP serving front end over the micro-batching engine, stdlib only (the
JAX package's ``infer/serve.py``, the same protocol byte for byte).

``aptai-torch-serve --checkpoint <trainer-run-dir> --port 8077`` loads any
checkpoint of either package (``infer/loader.py``), wraps the family's
predictor in :class:`~aptai_tpu_torch.infer.server.MicroBatcher` (requests
coalesce into one padded device batch) and serves:

  * ``GET  /healthz``     — liveness and model/service metadata
  * ``GET  /metrics``     — request counters and latency percentiles
  * ``POST /v1/predict``  — one utterance in, JSON outputs out
  * ``POST /v1/stream``   — one long recording in (beyond the predict
    cap), chunked on the device by ``infer/streaming.py``, stitched out

Request body, either:

  * ``application/octet-stream``: little-endian samples;
    ``X-Audio-Encoding: float32`` (default) ``| int16 | uint8_mulaw``
    (G.711, a quarter of float32's bytes); an ``X-Sample-Rate`` must be
    16000;
  * ``application/json``: ``{"audio": [floats in -1..1]}``.

``?fields=tvs_pred,phn_fc_pred`` keeps a subset of the served outputs.
Responses are JSON: ``{"frames": N, ...}`` with per-TV traces as ``{"TV
name": [floats]}`` and phoneme ids (and IPA when the checkpoint carries a
vocab). ``?format=binary`` (or ``X-Response-Format: binary``) sends the
packed binary frame of :func:`encode_binary` instead: the arrays as raw
little-endian buffers, decoded client-side by :func:`decode_binary`
(stdlib and numpy only).

``--checkpoint`` may also name a serving bundle of ``aptai-torch-export``
(``infer/export.py``): it serves ``/v1/predict`` at the bundle's static
shape and fields, with no model code and no ``/v1/stream``. A bundle of the
JAX package's ``aptai-export`` (a StableHLO program, which needs jax) is
refused with a message naming ``aptai-torch-export``.

The default transport is the C++ epoll front end
(``infer/native_transport.py`` over ``native/http_server.cpp``) when g++
builds it, else ``http.server``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from aptai_tpu_torch import SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.data.vocab import ids_to_phonemes
from aptai_tpu_torch.decode.beam import decode_with_times
from aptai_tpu_torch.infer.api import _log_softmax_host

# outputs each family serves by default (those of the batch CLI,
# infer/__main__.py); the predictors skip the heads none of them needs
KIND_FIELDS = {
    "aptai": ("tvs_pred", "phn_fc_pred"),
    "force_aptai": ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
                    "phn_seq_lengths"),
    "w2v2_pr": ("phoneme_logits",),
}

WIRE_ENCODINGS = ("float32", "int16", "uint8_mulaw")


def _mulaw_expand_host(q: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`aptai_tpu_torch.infer.api.quantize_mulaw`
    (the same continuous G.711 form as the device's
    ``dequantize_transfer``)."""
    y = (q.astype(np.float32) - 128.0) * np.float32(1.0 / 127.0)
    mu = np.float32(255.0)
    return np.sign(y) * (np.expm1(np.abs(y) * np.log1p(mu)) / mu)


def decode_wire_audio(body: bytes, content_type: str,
                      encoding: Optional[str],
                      sample_rate: Optional[str],
                      max_seconds: float) -> np.ndarray:
    """Request body → float32 waveform; raises ValueError on bad input
    (mapped to HTTP 400 by the handler)."""
    if sample_rate is not None and int(sample_rate) != SAMPLE_RATE:
        raise ValueError(
            f"X-Sample-Rate must be {SAMPLE_RATE} (got {sample_rate}); "
            "resample client-side")
    if (content_type or "").split(";")[0].strip() == "application/json":
        try:
            obj = json.loads(body)
            audio = np.asarray(obj["audio"], np.float32)
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            raise ValueError(f"bad JSON body: {e}") from None
        if audio.ndim != 1:
            raise ValueError("'audio' must be a flat list of samples")
    else:
        enc = encoding or "float32"
        if enc == "float32":
            audio = np.frombuffer(body, "<f4").astype(np.float32)
        elif enc == "int16":
            audio = (np.frombuffer(body, "<i2").astype(np.float32)
                     * np.float32(1.0 / 32768.0))
        elif enc == "uint8_mulaw":
            audio = _mulaw_expand_host(np.frombuffer(body, np.uint8))
        else:
            raise ValueError(
                f"unknown X-Audio-Encoding {enc!r}; expected one of "
                f"{list(WIRE_ENCODINGS)}")
    if audio.size == 0:
        raise ValueError("empty audio")
    if audio.size > max_seconds * SAMPLE_RATE:
        raise ValueError(
            f"audio longer than the serving cap ({max_seconds:.0f} s); "
            "use the streaming API (infer/streaming.py) for long files")
    return audio


def jsonify(obj):
    """Recursively convert numpy arrays/scalars to JSON-able types (the
    response payloads keep arrays until the transport boundary, so the
    binary path never round-trips through Python lists)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {k: jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    return obj


_BINARY_MAGIC = b"ATB1"


def encode_binary(payload: Dict) -> bytes:
    """Pack a response payload into the aptai binary frame:

    ``b"ATB1" | uint32le header_len | header JSON | raw array buffers``

    The header is ``{"fields": {"<dotted.path>": {"dtype": "<f4",
    "shape": [...], "offset": N}}, "meta": {...}}``: every numpy array in
    the payload (nested dicts use dotted paths, e.g. ``tvs_pred.LA``)
    ships as a contiguous little-endian buffer at its offset past the
    header; everything else stays JSON in ``meta``."""
    fields: Dict[str, Dict] = {}
    bufs: list = []
    offset = 0

    def split(prefix: str, val):
        nonlocal offset
        if isinstance(val, np.ndarray):
            arr = np.ascontiguousarray(val)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            fields[prefix] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                              "offset": offset}
            b = arr.tobytes()
            bufs.append(b)
            offset += len(b)
            return _OMIT
        if isinstance(val, dict):
            out = {}
            for k, v in val.items():
                r = split(f"{prefix}.{k}" if prefix else str(k), v)
                if r is not _OMIT:
                    out[k] = r
            return out
        return jsonify(val)

    _OMIT = object()
    meta = split("", payload)
    header = json.dumps({"fields": fields, "meta": meta}).encode()
    return b"".join([_BINARY_MAGIC, np.uint32(len(header)).tobytes(),
                     header, *bufs])


def decode_binary(data: bytes) -> Dict:
    """Client-side inverse of :func:`encode_binary` — rebuilds the payload
    dict with numpy arrays in place of the JSON lists."""
    if data[:4] != _BINARY_MAGIC:
        raise ValueError("not an aptai binary response (missing ATB1 magic)")
    hlen = int(np.frombuffer(data[4:8], "<u4")[0])
    header = json.loads(data[8 : 8 + hlen])
    base = 8 + hlen
    out = header["meta"]
    for path, spec in header["fields"].items():
        arr = np.frombuffer(
            data, np.dtype(spec["dtype"]), count=int(np.prod(spec["shape"],
                                                             dtype=np.int64)),
            offset=base + spec["offset"]).reshape(spec["shape"])
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


class ServingApp:
    """Transport-independent request logic: bytes in, (status, JSON) out.

    Separate from the socket layer so the protocol is testable without
    ports and reusable under another transport."""

    def __init__(self, batcher, kind: str, vocab: Optional[Dict] = None,
                 request_timeout_s: float = 60.0, max_seconds: float = 600.0,
                 meta: Optional[Dict] = None, streamer=None,
                 max_stream_seconds: float = 7200.0,
                 max_body_bytes: int = 1 << 30):
        if kind not in KIND_FIELDS:
            raise ValueError(f"unknown model kind {kind!r}")
        self.batcher = batcher
        self.kind = kind
        self.vocab = vocab
        self.request_timeout_s = request_timeout_s
        self.max_seconds = max_seconds
        # transport body cap (shared with the native front end, which 413s
        # before buffering); the stdlib handler enforces it BEFORE reading
        # so one bogus Content-Length can't OOM the host
        self.max_body_bytes = max_body_bytes
        self.meta = dict(meta or {})
        self.streamer = streamer
        self.max_stream_seconds = max_stream_seconds
        # streaming jobs serialize: two long recordings interleaving their
        # chunk groups on one card would double both jobs' wall clock and
        # thrash the micro-batcher's latency; short /v1/predict requests
        # still interleave freely with a running stream
        self._stream_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"requests_total": 0, "errors_total": 0,
                       "stream_requests_total": 0,
                       "audio_seconds_total": 0.0,
                       "stream_audio_seconds_total": 0.0,
                       "stream_wall_seconds_total": 0.0}
        self._latencies = deque(maxlen=1024)  # recent /v1/predict, seconds

    def _count(self, status: int, **adds) -> None:
        with self._stats_lock:
            self._stats["requests_total"] += 1
            if status >= 400:
                self._stats["errors_total"] += 1
            for k, v in adds.items():
                self._stats[k] += v

    # -- endpoints ----------------------------------------------------------

    def health(self) -> Tuple[int, Dict]:
        return 200, {
            "status": "ok",
            "model": self.kind,
            "max_batch_size": self.batcher.max_batch_size,
            "queue_depth": self.batcher._queue.qsize(),
            "fields": list(self.batcher.fields or ()),
            "streaming": self.streamer is not None,
            **self.meta,
        }

    def metrics(self) -> Tuple[int, Dict]:
        """Service counters and recent /v1/predict latency percentiles."""
        with self._stats_lock:
            stats = dict(self._stats)
            lat = np.sort(np.asarray(self._latencies, np.float64))
        out: Dict = {**stats,
                     "queue_depth": self.batcher._queue.qsize(),
                     "latency_window": int(lat.size)}
        if lat.size:
            out["latency_p50_ms"] = round(1e3 * float(lat[lat.size // 2]), 1)
            out["latency_p95_ms"] = round(
                1e3 * float(lat[int(lat.size * 0.95)]), 1)
        if stats["stream_wall_seconds_total"] > 0:
            out["stream_rtf"] = round(
                stats["stream_audio_seconds_total"]
                / stats["stream_wall_seconds_total"], 2)
        return 200, out

    def predict(self, body: bytes, content_type: str, headers,
                query: Dict) -> Tuple[int, Dict]:
        t0 = time.perf_counter()
        try:
            wav = decode_wire_audio(
                body, content_type,
                headers.get("X-Audio-Encoding"),
                headers.get("X-Sample-Rate"),
                self.max_seconds,
            )
        except ValueError as e:
            msg = str(e)
            if self.streamer is not None and "serving cap" in msg:
                msg += " — or POST it to /v1/stream on this server"
            self._count(400)
            return 400, {"error": msg}

        from concurrent.futures import TimeoutError as _FutTimeout

        fut = self.batcher.submit(wav)
        try:
            item = fut.result(timeout=self.request_timeout_s)
        except (TimeoutError, _FutTimeout):
            self._count(503)
            return 503, {"error":
                         f"timed out after {self.request_timeout_s:.0f} s "
                         "(server overloaded?)"}
        except Exception as e:  # batch-level failure fanned out to futures
            self._count(500)
            return 500, {"error": f"{type(e).__name__}: {e}"}

        payload = self._format(item, len(wav))
        status, payload = self._filter_fields(payload, query)
        self._count(status,
                    audio_seconds_total=len(wav) / SAMPLE_RATE)
        if status == 200:
            with self._stats_lock:
                self._latencies.append(time.perf_counter() - t0)
        return status, payload

    def stream(self, body: bytes, content_type: str, headers,
               query: Dict) -> Tuple[int, Dict]:
        """Long-recording inference over the chunked streamer (same wire
        protocol as /v1/predict, much larger duration cap)."""
        if self.streamer is None:
            self._count(404)
            return 404, {"error": "streaming is not enabled on this server"}
        try:
            wav = decode_wire_audio(
                body, content_type,
                headers.get("X-Audio-Encoding"),
                headers.get("X-Sample-Rate"),
                self.max_stream_seconds,
            )
        except ValueError as e:
            self._count(400)
            return 400, {"error": str(e)}
        t0 = time.perf_counter()
        try:
            with self._stream_lock:
                out = self.streamer.predict(wav)
        except Exception as e:  # device-side failure
            self._count(500)
            return 500, {"error": f"{type(e).__name__}: {e}"}
        wall = time.perf_counter() - t0
        payload = self._format_stream(out, len(wav))
        status, payload = self._filter_fields(payload, query)
        self._count(status,
                    stream_requests_total=1,
                    stream_audio_seconds_total=len(wav) / SAMPLE_RATE,
                    stream_wall_seconds_total=wall)
        return status, payload

    # -- transport-independent routing ------------------------------------

    def _encode(self, status: int, payload: Dict,
                fmt: str) -> Tuple[int, bytes, str]:
        """Payload → (status, body bytes, content type).  Errors are always
        JSON, whatever the requested format."""
        if fmt == "binary" and status == 200:
            return status, encode_binary(payload), "application/x-aptai-bin"
        return (status, json.dumps(jsonify(payload)).encode(),
                "application/json")

    def handle(self, method: str, target: str, headers,
               body: bytes) -> Tuple[int, bytes, str]:
        """One HTTP request → encoded response, independent of the socket
        layer. Both transports route through here: the stdlib
        ``http.server`` handler below and the native (C++ epoll) front
        end's slow lane (``infer/native_transport.py``; its fast lane
        decodes /v1/predict audio in C++ and re-joins at
        :meth:`predict`'s formatting stage). ``headers`` is any
        case-insensitive mapping with ``.get``."""
        parsed = urlparse(target)
        path = parsed.path
        query = parse_qs(parsed.query)
        if method == "GET":
            if path == "/healthz":
                status, payload = self.health()
            elif path == "/metrics":
                status, payload = self.metrics()
            else:
                status, payload = 404, {
                    "error": "unknown path; GET /healthz|/metrics "
                             "or POST /v1/predict|/v1/stream"}
            return self._encode(status, payload, "json")
        if method != "POST":
            return self._encode(
                405, {"error": f"method {method} not allowed"}, "json")
        handler = {"/v1/predict": self.predict,
                   "/v1/stream": self.stream}.get(path)
        if handler is None:
            return self._encode(
                404,
                {"error": "unknown path; POST /v1/predict or /v1/stream"},
                "json")
        fmt = (query.get("format")
               or [headers.get("X-Response-Format", "json")])[-1]
        if fmt not in ("json", "binary"):
            self._count(400)  # counted alike on both transports
            return self._encode(
                400, {"error": f"unknown response format {fmt!r}; "
                               "expected 'json' or 'binary'"}, "json")
        status, payload = handler(
            body, headers.get("Content-Type", ""), headers, query)
        return self._encode(status, payload, fmt)

    def _filter_fields(self, payload: Dict,
                       query: Dict) -> Tuple[int, Dict]:
        fields = query.get("fields")
        if fields:
            requested = [f for part in fields for f in part.split(",") if f]
            unknown = set(requested) - set(payload)
            if unknown:
                return 400, {"error":
                             f"unknown field(s) {sorted(unknown)}; this "
                             f"server produces {sorted(payload)}"}
            payload = {k: payload[k] for k in ("frames", *requested)
                       if k in payload}
        return 200, payload

    # -- per-family response shaping ------------------------------------

    def _ipa(self, ids) -> Optional[list]:
        if not self.vocab:
            return None
        return ids_to_phonemes(self.vocab, list(ids))

    def _format(self, item: Dict, wav_len: int) -> Dict:
        """One MicroBatcher item (arrays already cut to the utterance's
        frame count) → response payload, per model family.  Array values
        stay numpy until the transport boundary (``jsonify`` /
        ``encode_binary``)."""
        n = int(item["frame_lengths"])
        out: Dict = {"frames": n}
        if self.kind == "w2v2_pr":
            logits = np.asarray(item["phoneme_logits"], np.float32)
            tokens, times = decode_with_times(_log_softmax_host(logits))
            ratio = wav_len / max(n, 1) / SAMPLE_RATE
            out["phn_seq_idx"] = np.asarray(tokens, np.int32)
            out["phn_seq_dur"] = (np.asarray(times, np.float32)
                                  * np.float32(ratio))
            ipa = self._ipa(tokens)
            if ipa is not None:
                out["phn_seq_ipa"] = ipa
            return out

        tvs = np.asarray(item["tvs_pred"], np.float32)
        out["tvs_pred"] = {k: tvs[:, i] for i, k in enumerate(TV_ORDER)}
        frame_key = ("phn_fc_pred" if self.kind == "aptai"
                     else "pred_frame_phns")
        frames = np.asarray(item[frame_key])
        out[frame_key] = frames
        ipa = self._ipa([int(x) for x in frames])
        if ipa is not None:
            out[f"{frame_key}_ipa"] = ipa
        if self.kind == "force_aptai":
            s = int(item["phn_seq_lengths"])
            seq = np.asarray(item["pred_ctc_phn_seq"])[:s]
            out["pred_ctc_phn_seq"] = seq
            ipa = self._ipa([int(x) for x in seq])
            if ipa is not None:
                out["pred_ctc_phn_seq_ipa"] = ipa
        return out

    def _format_stream(self, out: Dict, wav_len: int) -> Dict:
        """One streamer result (stitched, full-recording arrays) → response
        payload mirroring the /v1/predict schema of the same family (arrays
        stay numpy until the transport boundary)."""
        if self.kind == "w2v2_pr":
            logits = np.asarray(out["phoneme_logits"], np.float32)
            n = len(logits)
            tokens, times = decode_with_times(_log_softmax_host(logits))
            ratio = wav_len / max(n, 1) / SAMPLE_RATE
            payload: Dict = {
                "frames": n,
                "phn_seq_idx": np.asarray(tokens, np.int32),
                "phn_seq_dur": (np.asarray(times, np.float32)
                                * np.float32(ratio)),
            }
            ipa = self._ipa(tokens)
            if ipa is not None:
                payload["phn_seq_ipa"] = ipa
            return payload

        frame_key = ("phn_fc_pred" if self.kind == "aptai"
                     else "pred_frame_phns")
        frames = np.asarray(out[frame_key])
        payload = {
            "frames": len(frames),
            "tvs_pred": {k: np.asarray(v)
                         for k, v in out["tvs_pred"].items()},
            frame_key: frames,
        }
        ipa = self._ipa([int(x) for x in frames])
        if ipa is not None:
            payload[f"{frame_key}_ipa"] = ipa
        return payload


class _Handler(BaseHTTPRequestHandler):
    app: ServingApp  # bound by make_server

    # HTTP/1.1 + Content-Length (always set in _send) => persistent
    # connections: a client streaming utterances reuses one socket instead
    # of paying connect + slow-start per request.  Nagle off: responses are
    # one small write each — coalescing only adds latency on localhost.
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    # keep the request path quiet; errors surface as JSON statuses
    def log_message(self, *args):
        pass

    def _dispatch(self, method: str) -> None:
        body = b""
        if method == "POST":
            try:
                clen = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                clen = -1
            if clen < 0 or clen > self.app.max_body_bytes:
                # reject BEFORE buffering: reading a hostile Content-Length
                # into RAM first would let one request OOM the host.  The
                # unread body makes the socket unusable for keep-alive, so
                # close it (the native transport 413s pre-buffer the same
                # way — native/http_server.cpp parse_conn).
                status, payload = (
                    (413, {"error": "request body too large"}) if clen > 0
                    else (400, {"error": "bad Content-Length"}))
                status, data, ctype = self.app._encode(
                    status, payload, "json")
                self.close_connection = True
                self._send(status, data, ctype, close=True)
                return
            body = self.rfile.read(clen)
        status, data, ctype = self.app.handle(
            method, self.path, self.headers, body)
        self._send(status, data, ctype)

    def _send(self, status: int, data: bytes, ctype: str,
              close: bool = False) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        if close:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_server(app: ServingApp, host: str = "127.0.0.1",
                port: int = 8077) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server to ``app`` (port 0 picks a free port;
    the bound port is ``server.server_address[1]``)."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


STREAMER_CLASSES = {
    "aptai": "StreamingAPTAI",
    "force_aptai": "StreamingForceAPTAI",
    "w2v2_pr": "StreamingW2V2PR",
}


def _is_jax_bundle(path) -> bool:
    p = Path(path)
    return (p / "forward.stablehlo").is_file() and (p / "meta.json").is_file()


def is_bundle(path) -> bool:
    """True when ``path`` is a serving bundle directory (vs a trainer
    checkpoint): this package's (``aptai-torch-export``) or the JAX
    package's (``aptai-export``), which :func:`build_app_from_bundle`
    refuses."""
    from aptai_tpu_torch.infer import export

    return export.is_bundle(path) or _is_jax_bundle(path)


def build_app_from_bundle(bundle_dir, max_wait_ms: float = 10.0,
                          fetch_workers: int = 4,
                          request_timeout_s: float = 60.0,
                          warmup: bool = True, device=None) -> ServingApp:
    """Serving bundle directory → started ServingApp, on ``device``
    (``cuda`` unless named; one of the bundle's platforms).

    The bundle (``infer/export.py``: the exported program, its weights and
    metadata) carries its own static shape, baked output fields and wire
    encoding, so the serving host needs no model code and no checkpoint
    loader. ``/v1/stream`` is unavailable (the chunked streamer needs the
    live model); ``max_seconds`` is the exported shape's cap."""
    from aptai_tpu_torch.infer import export
    from aptai_tpu_torch.infer.server import MicroBatcher

    if not export.is_bundle(bundle_dir):
        raise ValueError(
            f"{bundle_dir} is a serving bundle of the JAX package "
            "(aptai-export: a StableHLO program, which runs only under jax); "
            "aptai_tpu_torch serves its own bundles: export the checkpoint "
            "it came from with `aptai-torch-export <checkpoint> <out_dir>`, "
            "or serve that checkpoint directly")
    bundle = export.load_serving_bundle(bundle_dir, device=device)
    kind = bundle.meta.get("kind")
    if kind not in KIND_FIELDS:
        raise ValueError(
            f"bundle {bundle_dir} records no serving family (kind="
            f"{kind!r}); re-export it with aptai-torch-export, which stamps "
            "the family and vocabulary into meta.json")
    max_seconds = bundle.meta["samples"] / SAMPLE_RATE
    batcher = MicroBatcher(
        bundle.predict_batch, max_batch_size=int(bundle.meta["batch"]),
        max_wait_ms=max_wait_ms, pad_to_max=False,  # the bundle pads itself
        fields=None,  # baked into the program at export time
        fetch_workers=fetch_workers,
    )
    if warmup:
        batcher.warmup(seconds=min(2.0, max_seconds))
    batcher.start()
    return ServingApp(batcher, kind, vocab=bundle.meta.get("vocab"),
                      request_timeout_s=request_timeout_s,
                      max_seconds=max_seconds,
                      meta={"bundle": str(bundle_dir),
                            "platforms": bundle.meta.get("platforms")},
                      streamer=None)


def build_app(checkpoint: str, fields: Optional[Sequence[str]] = None,
              max_batch_size: int = 16, max_wait_ms: float = 10.0,
              transfer_dtype: str = "float32", dtype: Optional[str] = None,
              quant: Optional[str] = None,
              fetch_workers: int = 4, request_timeout_s: float = 60.0,
              max_seconds: float = 600.0, warmup: bool = True,
              warmup_seconds: float = 10.0, streaming: bool = True,
              chunk_seconds: float = 20.0, overlap_seconds: float = 2.0,
              chunk_batch: int = 4,
              max_stream_seconds: float = 7200.0,
              device=None) -> ServingApp:
    """Checkpoint directory → started ServingApp: the predictor and its
    batcher, and the long-audio streamer sharing the predictor's serving
    model, on ``device`` (``cuda`` unless named). A serving bundle
    directory is detected and served by :func:`build_app_from_bundle`:
    the same endpoints but ``/v1/stream``, no model code."""
    from aptai_tpu_torch.infer import streaming as streaming_mod
    from aptai_tpu_torch.infer.api import (APTAIPredictor,
                                          ForceAPTAIPredictor,
                                          W2V2PRPredictor)
    from aptai_tpu_torch.infer.loader import load_model
    from aptai_tpu_torch.infer.server import MicroBatcher

    if is_bundle(checkpoint):
        return build_app_from_bundle(
            checkpoint, max_wait_ms=max_wait_ms,
            fetch_workers=fetch_workers,
            request_timeout_s=request_timeout_s, warmup=warmup,
            device=device)

    kind, model, vocab = load_model(checkpoint, dtype=dtype, quant=quant)
    kw = dict(device=device, transfer_dtype=transfer_dtype)
    if kind == "w2v2_pr":
        pred = W2V2PRPredictor(model, vocab, **kw)
        entry = pred.encode_batch
    elif kind == "aptai":
        pred = APTAIPredictor(model, **kw)
        entry = pred.predict_batch
    else:
        pred = ForceAPTAIPredictor(model, **kw)
        entry = pred.predict_batch
    batcher = MicroBatcher(
        entry, max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
        fields=tuple(fields) if fields else KIND_FIELDS[kind],
        fetch_workers=fetch_workers,
    )
    if warmup:
        batcher.warmup(seconds=warmup_seconds)
    batcher.start()
    streamer = None
    if streaming:
        cls = getattr(streaming_mod, STREAMER_CLASSES[kind])
        try:
            streamer = cls(pred.model, chunk_seconds=chunk_seconds,
                           overlap_seconds=overlap_seconds,
                           chunk_batch=chunk_batch,
                           transfer_dtype=transfer_dtype, device=pred.device)
        except ValueError as e:
            # a beam_host FORCE model cannot stream: serve /v1/predict only
            print(f"aptai-torch-serve: /v1/stream disabled: {e}",
                  file=sys.stderr)
        if streamer is not None and warmup:
            streamer.predict(np.zeros(SAMPLE_RATE, np.float32))
    return ServingApp(batcher, kind, vocab=vocab,
                      request_timeout_s=request_timeout_s,
                      max_seconds=max_seconds,
                      meta={"checkpoint": str(checkpoint)},
                      streamer=streamer,
                      max_stream_seconds=max_stream_seconds)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aptai-torch-serve",
        description="HTTP serving for aptai_tpu_torch and aptai_tpu "
                    "checkpoints (micro-batched, one padded device shape)")
    p.add_argument("--checkpoint", required=True,
                   help="trainer run dir, best-model-ckpt dir, or serving "
                        "bundle dir (aptai-torch-export)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8077)
    p.add_argument("--max_batch_size", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--fields", default="",
                   help="comma list; default: the family's serving set")
    p.add_argument("--transfer_dtype", default="float32",
                   choices=("float32", "int16", "uint8_mulaw"),
                   help="host->device audio upload encoding")
    p.add_argument("--dtype", default=None,
                   help="compute dtype override (e.g. bfloat16)")
    p.add_argument("--quant", default=None,
                   choices=("w8a8_ffn", "w8a8"),
                   help="int8 W8A8 GEMMs (not implemented yet: raises)")
    p.add_argument("--fetch_workers", type=int, default=4)
    p.add_argument("--timeout_s", type=float, default=60.0)
    p.add_argument("--max_seconds", type=float, default=600.0,
                   help="reject single /v1/predict requests longer than "
                        "this (long files go to /v1/stream)")
    p.add_argument("--warmup_seconds", type=float, default=10.0,
                   help="audio length of the warm-up batches")
    p.add_argument("--no_streaming", action="store_true",
                   help="disable the /v1/stream long-audio endpoint")
    p.add_argument("--chunk_seconds", type=float, default=20.0)
    p.add_argument("--overlap_seconds", type=float, default=2.0)
    p.add_argument("--chunk_batch", type=int, default=4,
                   help="chunks per device forward on /v1/stream (higher = "
                        "more throughput, longer per-group latency)")
    p.add_argument("--max_stream_seconds", type=float, default=7200.0,
                   help="reject /v1/stream requests longer than this")
    p.add_argument("--transport", default="auto",
                   choices=("auto", "python", "native"),
                   help="HTTP front end: 'native' = C++ epoll transport "
                        "(native/http_server.cpp: socket I/O, parsing and "
                        "wire decode off the GIL), 'python' = stdlib "
                        "http.server, 'auto' = native when g++ builds it, "
                        "else python")
    p.add_argument("--cpu", action="store_true",
                   help="run the model on the CPU (the default is the card)")
    return p


def bundle_ignored_flags(args, parser) -> list:
    """Flags that an AOT bundle fixes at export time: the non-default ones
    among them, which serving a bundle would ignore."""
    baked = ("fields", "transfer_dtype", "dtype", "quant", "max_batch_size",
             "max_seconds", "warmup_seconds", "chunk_seconds",
             "overlap_seconds", "chunk_batch", "max_stream_seconds")
    return [f"--{n}" for n in baked
            if getattr(args, n) != parser.get_default(n)]


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if is_bundle(args.checkpoint):
        ignored = bundle_ignored_flags(args, parser)
        if ignored:
            print("aptai-torch-serve: the checkpoint is an AOT bundle — "
                  f"{', '.join(ignored)} are fixed at export time",
                  file=sys.stderr)
    try:
        app = build_app(
            args.checkpoint,
            fields=[f for f in args.fields.split(",") if f] or None,
            max_batch_size=args.max_batch_size,
            max_wait_ms=args.max_wait_ms,
            transfer_dtype=args.transfer_dtype, dtype=args.dtype,
            quant=args.quant, fetch_workers=args.fetch_workers,
            request_timeout_s=args.timeout_s, max_seconds=args.max_seconds,
            warmup_seconds=args.warmup_seconds,
            streaming=not args.no_streaming,
            chunk_seconds=args.chunk_seconds,
            overlap_seconds=args.overlap_seconds,
            chunk_batch=args.chunk_batch,
            max_stream_seconds=args.max_stream_seconds,
            device="cpu" if args.cpu else None,
        )
    except ValueError as e:
        if not is_bundle(args.checkpoint):
            raise
        # a JAX bundle, or one without a family: a usage error
        print(f"aptai-torch-serve: {e}", file=sys.stderr)
        return 2
    transport = args.transport
    if transport == "auto":
        from aptai_tpu_torch.infer.native_transport import (
            native_transport_available)

        transport = ("native" if native_transport_available() else "python")
    if transport == "native":
        from aptai_tpu_torch.infer.native_transport import make_native_server

        server = make_native_server(app, args.host, args.port)
    else:
        server = make_server(app, args.host, args.port)

    stop_evt = threading.Event()

    def _shutdown(signum, frame):
        print(f"received {signal.Signals(signum).name}: draining",
              file=sys.stderr)
        threading.Thread(target=server.shutdown, daemon=True).start()
        stop_evt.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    print(f"aptai-torch-serve: {app.kind} on "
          f"http://{server.server_address[0]}:{server.server_address[1]} "
          f"({transport} transport, batch {args.max_batch_size}, fields "
          f"{list(app.batcher.fields or ())}, streaming "
          f"{'on' if app.streamer is not None else 'off'})", flush=True)
    try:
        if transport == "native":
            stop_evt.wait()  # the C++ I/O thread serves until a signal
        else:
            server.serve_forever()
    finally:
        app.batcher.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
