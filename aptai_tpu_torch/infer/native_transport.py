"""Native (C++ epoll) HTTP transport for ``aptai-torch-serve`` (the JAX
package's ``infer/native_transport.py``).

Binds ``native/http_server.cpp`` to a
:class:`~aptai_tpu_torch.infer.serve.ServingApp`: socket I/O, HTTP parsing,
wire-audio decoding (float32/int16/uint8_mulaw) and micro-batch coalescing
run in a C++ epoll thread off the GIL; Python wakes once per batch, not per
request, runs the forward, formats responses and hands the bytes back to
C++ to frame and write. g++ compiles ``http_server.cpp`` alone into
``aptai_tpu_torch/_build/`` at first use
(:mod:`aptai_tpu_torch.utils.cxx_build`).

Two request lanes:

* **fast**: ``POST /v1/predict`` with an octet-stream body, decoded to
  float32 in C++, coalesced into one (max_batch, stride) buffer and served
  by :meth:`NativeHTTPServer._fast_loop` through the app's
  ``MicroBatcher`` dispatch and split (the same device path and response
  formatting: payloads byte-identical to the Python transport's);
* **slow**: everything else (GET endpoints, JSON bodies, ``/v1/stream``,
  oversized or malformed uploads): the raw request crosses to Python and
  routes through ``ServingApp.handle``, so validation and errors are those
  of the stdlib transport by construction.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from email.parser import Parser as _HeaderParser
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs

import numpy as np

from aptai_tpu_torch import SAMPLE_RATE
from aptai_tpu_torch.utils import cxx_build

SOURCE = cxx_build.NATIVE_DIR / "http_server.cpp"
BUILD_DIR = cxx_build.BUILD_DIR
CXX_FLAGS = cxx_build.CXX_FLAGS + ("-pthread",)
_QUERY_CAP = 512
# slow-lane target/header buffer size: the C++ parser rejects (431) header
# blocks over 64 KiB, so this bound is authoritative, not heuristic
_SLOW_BUF_CAP = 65536 + 16

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.aptai_http_start.restype = c.c_int64
    lib.aptai_http_start.argtypes = [c.c_char_p, c.c_int32, c.c_int64,
                                     c.c_int64]
    lib.aptai_http_port.restype = c.c_int32
    lib.aptai_http_port.argtypes = [c.c_int64]
    lib.aptai_http_stop.restype = None
    lib.aptai_http_stop.argtypes = [c.c_int64]
    lib.aptai_http_next_batch.restype = c.c_int32
    lib.aptai_http_next_batch.argtypes = [
        c.c_int64, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int32),
        c.POINTER(c.c_uint64), c.POINTER(c.c_int64), c.c_char_p, c.c_int32,
    ]
    lib.aptai_http_next_slow.restype = c.c_int32
    lib.aptai_http_next_slow.argtypes = [
        c.c_int64, c.c_int32, c.POINTER(c.c_uint64),
        c.c_char_p, c.c_int32, c.c_char_p, c.c_int32,
        c.c_char_p, c.c_int32, c.POINTER(c.c_int64),
    ]
    lib.aptai_http_fetch_body.restype = c.c_int64
    lib.aptai_http_fetch_body.argtypes = [
        c.c_int64, c.c_uint64, c.POINTER(c.c_uint8), c.c_int64]
    lib.aptai_http_respond.restype = None
    lib.aptai_http_respond.argtypes = [
        c.c_int64, c.c_uint64, c.c_int32, c.c_char_p, c.c_char_p, c.c_int64]
    lib.aptai_http_set_mulaw_table.restype = None
    lib.aptai_http_set_mulaw_table.argtypes = [c.c_int64,
                                               c.POINTER(c.c_float)]
    return lib


def library_path():
    """Where the built library lives: keyed by the source and the flags."""
    return cxx_build.library_path(SOURCE, "libaptai_http", BUILD_DIR,
                                  CXX_FLAGS)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built (the reason in :func:`build_error`)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                cxx_build.build(SOURCE, out, CXX_FLAGS)
            _lib = _bind(ctypes.CDLL(str(out)))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _build_error = str(e)
        return _lib


def native_transport_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Load the library (building it if needed) and say why that failed:
    None if it loaded."""
    _load()
    return _build_error


class NativeHTTPServer:
    """C++ transport bound to a ServingApp; the same endpoints and payloads
    as :func:`aptai_tpu_torch.infer.serve.make_server`, with far less host
    CPU per request."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8077, *,
                 fast_max_seconds: float = 60.0,
                 max_body_bytes: int = 1 << 30, slow_workers: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native transport unavailable: g++ could not "
                               f"build {SOURCE.name}: {_build_error}")
        self._lib = lib
        self.app = app
        self.batcher = app.batcher
        self._max_batch = int(self.batcher.max_batch_size)
        # fast-lane cap: longer uploads fall to the slow lane (still served,
        # through ServingApp.predict) instead of sizing this buffer for the
        # 600 s predict cap
        self._stride = int(min(fast_max_seconds, app.max_seconds)
                           * SAMPLE_RATE)
        self._wait_ms = max(int(self.batcher.max_wait_ms), 1)
        self._slow_workers = max(int(slow_workers), 1)
        self._h = self._lib.aptai_http_start(
            host.encode(), int(port), int(max_body_bytes), self._stride)
        if self._h < 0:
            raise OSError(f"native transport failed to bind {host}:{port}")
        self.host = host
        self.port = int(self._lib.aptai_http_port(self._h))
        self.server_address = (host, self.port)

        # bit-exact mu-law expansion: install the numpy-computed table so
        # C++-decoded audio is identical to the Python transport's
        from aptai_tpu_torch.infer.serve import _mulaw_expand_host

        lut = np.ascontiguousarray(
            _mulaw_expand_host(np.arange(256, dtype=np.uint8)), np.float32)
        self._mulaw_lut = lut  # keep alive
        self._lib.aptai_http_set_mulaw_table(
            self._h, lut.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

        self._audio = np.zeros((self._max_batch, self._stride), np.float32)
        self._lengths = np.zeros(self._max_batch, np.int32)
        self._ids = np.zeros(self._max_batch, np.uint64)
        self._recv_us = np.zeros(self._max_batch, np.int64)
        self._queries = ctypes.create_string_buffer(
            self._max_batch * _QUERY_CAP)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stream_pool: Optional[ThreadPoolExecutor] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "NativeHTTPServer":
        self._pool = ThreadPoolExecutor(
            max(int(self.batcher.fetch_workers), 1))
        # /v1/stream runs for the recording's wall clock (serialized on
        # app._stream_lock); handled inline it would pin a slow worker and —
        # with a second stream blocked on the lock — starve /healthz and
        # /metrics for minutes.  A dedicated 1-thread pool keeps the slow
        # workers free (queued streams serialize here, same semantics as
        # the lock).
        self._stream_pool = ThreadPoolExecutor(
            1, thread_name_prefix="aptai-native-stream")
        t = threading.Thread(target=self._fast_loop, daemon=True,
                             name="aptai-native-fast")
        t.start()
        self._threads.append(t)
        for i in range(self._slow_workers):
            t = threading.Thread(target=self._slow_loop, daemon=True,
                                 name=f"aptai-native-slow-{i}")
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._lib.aptai_http_stop(self._h)  # wakes every blocked call
        for t in self._threads:
            t.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._stream_pool is not None:
            self._stream_pool.shutdown(wait=True)
            self._stream_pool = None

    stop = shutdown

    # -- response plumbing ---------------------------------------------------

    def _respond(self, req_id: int, status: int, ctype: str,
                 data: bytes) -> None:
        self._lib.aptai_http_respond(self._h, req_id, status,
                                     ctype.encode(), data, len(data))

    def _respond_error(self, req_id: int, status: int, msg: str) -> None:
        status, data, ctype = self.app._encode(status, {"error": msg},
                                               "json")
        self._respond(req_id, status, ctype, data)

    # -- fast lane: batched /v1/predict --------------------------------------

    def _fast_loop(self) -> None:
        lib, app = self._lib, self.app
        audio_p = self._audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        len_p = self._lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        ids_p = self._ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        us_p = self._recv_us.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        while not self._stop.is_set():
            n = lib.aptai_http_next_batch(
                self._h, self._max_batch, 200, self._wait_ms,
                audio_p, self._stride, len_p, ids_p, us_p,
                self._queries, _QUERY_CAP)
            if n < 0:
                break
            if n == 0:
                continue
            raw_q = self._queries.raw
            timeout_s = float(app.request_timeout_s or 0)
            now = time.monotonic()
            metas = []
            wavs = []
            for i in range(n):
                rid = int(self._ids[i])
                recv_us = int(self._recv_us[i])
                raw = raw_q[i * _QUERY_CAP:(i + 1) * _QUERY_CAP]
                query = raw.split(b"\0", 1)[0].decode("utf-8", "replace")
                # load shedding: the Python transport 503s a request whose
                # future exceeds request_timeout_s; here requests age in the
                # C++ intake queue instead, so enforce the same contract on
                # queue wait before spending device time on them
                if timeout_s > 0 and now - recv_us / 1e6 > timeout_s:
                    app._count(503)
                    self._respond_error(
                        rid, 503, f"timed out after {timeout_s:.0f} s "
                                  "(server overloaded?)")
                    continue
                q = parse_qs(query)
                fmt = (q.get("format") or ["json"])[-1]
                if fmt not in ("json", "binary"):
                    # same pre-compute rejection + counting as
                    # ServingApp.handle (no audio_seconds for a request
                    # that served none)
                    app._count(400)
                    self._respond_error(
                        rid, 400, f"unknown response format {fmt!r}; "
                                  "expected 'json' or 'binary'")
                    continue
                metas.append((rid, recv_us, q, fmt))
                # the intake buffer is reused by the next next_batch call
                wavs.append(self._audio[i, :int(self._lengths[i])].copy())
            if not wavs:
                continue
            try:
                n_wavs, out = self.batcher._dispatch(wavs)
            except Exception as e:  # device failure
                for rid, _, _, _ in metas:
                    app._count(500)
                    self._respond_error(rid, 500,
                                        f"{type(e).__name__}: {e}")
                continue
            self._pool.submit(self._resolve, metas,
                              [len(w) for w in wavs], n_wavs, out)

    def _resolve(self, metas: Sequence[Tuple[int, int, Dict, str]],
                 wav_lens: Sequence[int], n_wavs: int, out: Dict) -> None:
        app = self.app
        try:
            items = self.batcher._split(n_wavs, out)
        except Exception as e:  # fetch failure
            for rid, _, _, _ in metas:
                app._count(500)
                self._respond_error(rid, 500, f"{type(e).__name__}: {e}")
            return
        for (rid, recv_us, q, fmt), wav_len, item in zip(metas, wav_lens,
                                                         items):
            try:
                payload = app._format(item, wav_len)
                status, payload = app._filter_fields(payload, q)
                status, data, ctype = app._encode(status, payload, fmt)
            except Exception as e:  # formatting bug
                status, data, ctype = app._encode(
                    500, {"error": f"{type(e).__name__}: {e}"}, "json")
            # count BEFORE responding: a client reading /metrics right
            # after its response must see itself counted
            app._count(status, audio_seconds_total=wav_len / SAMPLE_RATE)
            if status == 200:
                # C++ stamps steady_clock (CLOCK_MONOTONIC on Linux); so is
                # time.monotonic — same epoch, so end-to-end latency incl.
                # queueing is the difference
                lat = max(time.monotonic() - recv_us / 1e6, 0.0)
                with app._stats_lock:
                    app._latencies.append(lat)
            self._respond(rid, status, ctype, data)

    # -- slow lane: everything else -------------------------------------------

    def _slow_loop(self) -> None:
        lib = self._lib
        rid = ctypes.c_uint64()
        body_len = ctypes.c_int64()
        # sized to the C++ protocol maxima (parse_conn 431s header blocks —
        # request line included — over 64 KiB) so `put` can never silently
        # truncate a header or query string
        method = ctypes.create_string_buffer(16)
        target = ctypes.create_string_buffer(_SLOW_BUF_CAP)
        headers = ctypes.create_string_buffer(_SLOW_BUF_CAP)
        while not self._stop.is_set():
            r = lib.aptai_http_next_slow(
                self._h, 200, ctypes.byref(rid), method, 16,
                target, _SLOW_BUF_CAP, headers, _SLOW_BUF_CAP,
                ctypes.byref(body_len))
            if r < 0:
                break
            if r == 0:
                continue
            req_id = int(rid.value)
            body = b""
            nbody = int(body_len.value)
            if nbody > 0:
                buf = np.empty(nbody, np.uint8)
                got = lib.aptai_http_fetch_body(
                    self._h, req_id,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    nbody)
                body = buf[:max(int(got), 0)].tobytes()
            method_s = method.value.decode("latin-1")
            target_s = target.value.decode("latin-1")
            headers_s = headers.value.decode("latin-1")
            if method_s == "POST" and target_s.split("?", 1)[0] == "/v1/stream":
                # long-running: hand off so this worker stays responsive
                self._stream_pool.submit(
                    self._handle_slow, req_id, method_s, target_s,
                    headers_s, body)
            else:
                self._handle_slow(req_id, method_s, target_s, headers_s,
                                  body)

    def _handle_slow(self, req_id: int, method: str, target: str,
                     headers_raw: str, body: bytes) -> None:
        app = self.app
        try:
            hdr_map = _HeaderParser().parsestr(headers_raw)
            status, data, ctype = app.handle(method, target, hdr_map, body)
        except Exception as e:  # handler bug
            status, data, ctype = app._encode(
                500, {"error": f"{type(e).__name__}: {e}"}, "json")
        self._respond(req_id, status, ctype, data)


def make_native_server(app, host: str = "127.0.0.1",
                       port: int = 8077, **kw) -> NativeHTTPServer:
    """Counterpart of :func:`aptai_tpu_torch.infer.serve.make_server` for
    the C++ transport (port 0 picks a free port; started — call
    ``shutdown()`` when done)."""
    return NativeHTTPServer(app, host, port, **kw).start()
