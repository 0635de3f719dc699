"""Micro-batching inference server core.

Requests are queued on the host, coalesced into batches padded to one
serving shape, run on the device and fanned back out per request. The core
is synchronous (``run_batch`` / ``serve_pending``) and also runs on a
background thread (``start`` / ``submit`` / ``Future`` / ``stop``).

The dispatching thread only enqueues device work (``predict_batch`` does
not synchronise); results are fetched and split on a small thread pool, so
the dispatch loop drains and enqueues the next micro-batch meanwhile.
"""

from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from aptai_tpu_torch.infer.api import fetch_outputs


class MicroBatcher:
    def __init__(
        self,
        predict_batch: Callable[..., Dict],
        max_batch_size: int = 32,
        max_wait_ms: float = 10.0,
        pad_to_max: bool = True,
        fields: Optional[Sequence[str]] = None,
        fetch_workers: int = 4,
    ):
        """Args:
          predict_batch: batched entry point (e.g.
            ``APTAIPredictor.predict_batch``) returning a dict of
            ``(B, ...)`` tensors plus ``frame_lengths``, leading dim ==
            number of wavs passed.
          pad_to_max: pad every drained micro-batch to ``max_batch_size``
            with silence rows, so the device sees one serving shape.
          fields: forwarded to ``predict_batch(fields=...)``.
          fetch_workers: threads that fetch and split results in the
            background server; 1 resolves on the dispatch thread.
        """
        self.predict_batch = predict_batch
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.pad_to_max = pad_to_max
        self.fields = tuple(fields) if fields is not None else None
        try:
            self._pass_real_rows = "real_rows" in inspect.signature(
                predict_batch).parameters
        except (TypeError, ValueError):  # builtins / C callables
            self._pass_real_rows = False
        self.fetch_workers = max(int(fetch_workers), 1)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stop = threading.Event()

    # -- synchronous core ---------------------------------------------------

    def warmup(self, seconds: float = 2.0, rate: int = 16_000,
               cycles: int = 2):
        """Run the serving shape ``cycles`` times before taking traffic."""
        wav = np.zeros(int(seconds * rate), np.float32)
        for _ in range(max(cycles, 1)):
            self.run_batch([wav] * (self.max_batch_size if self.pad_to_max
                                    else 1))
        return self

    def _dispatch(self, wavs: Sequence[np.ndarray]) -> Tuple[int, Dict]:
        """Pad to the serving shape and enqueue the forward."""
        fill = list(wavs)
        if self.pad_to_max and len(fill) < self.max_batch_size:
            pad = np.zeros_like(np.asarray(fill[0]))
            fill.extend([pad] * (self.max_batch_size - len(fill)))
        kw = {}
        if self.fields is not None:
            kw["fields"] = self.fields
        if self._pass_real_rows:
            kw["real_rows"] = len(wavs)
        out = self.predict_batch(fill, **kw)
        return len(wavs), out

    @staticmethod
    def _split(n_wavs: int, out: Dict) -> List[Dict]:
        """Fetch the outputs and split them per request item; frame-axis
        arrays are cut to the item's frame count."""
        host = fetch_outputs(out)
        frame_lengths = host["frame_lengths"]
        results = []
        for b in range(n_wavs):
            n = int(frame_lengths[b])
            item = {}
            for k, arr in host.items():
                if arr.ndim >= 2:
                    item[k] = arr[b, :n] if arr.shape[1] >= n else arr[b]
                else:
                    item[k] = arr[b]
            results.append(item)
        return results

    def run_batch(self, wavs: Sequence[np.ndarray]) -> List[Dict]:
        """Run one coalesced batch and split results per item."""
        return self._split(*self._dispatch(wavs))

    # -- background request/response -----------------------------------------

    def submit(self, wav: np.ndarray) -> "Future":
        fut: Future = Future()
        self._queue.put((np.asarray(wav, np.float32), fut))
        return fut

    def _resolve(self, items, n_wavs: int, out: Dict) -> None:
        try:
            results = self._split(n_wavs, out)
        except Exception as e:  # every waiting request learns of it
            for _, fut in items:
                fut.set_exception(e)
            return
        for (_, fut), res in zip(items, results):
            fut.set_result(res)

    def serve_pending(self) -> int:
        """Drain up to one micro-batch from the queue, dispatch it and
        resolve it (on the fetch pool when running in the background).
        Returns the number of requests served."""
        items = []
        try:
            items.append(self._queue.get(timeout=self.max_wait_ms / 1000))
        except queue.Empty:
            return 0
        while len(items) < self.max_batch_size:
            try:
                items.append(self._queue.get_nowait())
            except queue.Empty:
                break
        wavs = [w for w, _ in items]
        try:
            n_wavs, out = self._dispatch(wavs)
        except Exception as e:  # every waiting request learns of it
            for _, fut in items:
                fut.set_exception(e)
            return len(items)
        if self._pool is not None:
            self._pool.submit(self._resolve, items, n_wavs, out)
        else:
            self._resolve(items, n_wavs, out)
        return len(items)

    def _loop(self):
        while not self._stop.is_set():
            self.serve_pending()

    def start(self):
        self._stop.clear()
        if self.fetch_workers > 1:
            self._pool = ThreadPoolExecutor(self.fetch_workers)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
