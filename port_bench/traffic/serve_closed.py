"""Closed-loop batch serving: ``APTAIPredictor.predict_batch`` over batches
of the workload's size, at most ``ahead`` batches in flight.

A dispatching thread pads, uploads and enqueues each batch (the program's
``predict_batch``); the calling thread fetches each batch's outputs with the
program's ``fetch_outputs`` in order, and frees a place for the next. The
batches are a pool of ``pool_batches`` drawn from the seed, served in turn.

Parameters: ``batch``, ``min_s``, ``max_s``, ``pool_batches``, ``ahead``,
``fields``, ``trace_batches`` (the traced segment), ``check_batches`` (the
batches compared with the reference: drawn from the seed over every batch
the window completes, and the window's last batch that holds the longest
utterance of the pool).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from port_bench import data, serving
from port_bench.core import KindBase


class Kind(KindBase):
    def __init__(self, run, overrides=None):
        super().__init__(run)
        p = run.params
        rng = np.random.default_rng(run.seed_for("traffic"))
        n = p["batch"] * p["pool_batches"]
        lengths = data.stratified_lengths(n, p["min_s"], p["max_s"], rng)
        wavs = data.waveforms(lengths, rng)
        self.pool = [wavs[i:i + p["batch"]] for i in range(0, n, p["batch"])]
        self.fields = tuple(p["fields"])
        run.phase("inputs")
        self.served = serving.Served(run, overrides)
        self.served.warm(p["batch"], [data.bucket(max(len(w) for w in b))
                                      for b in self.pool], self.fields)
        # (pool index, host outputs) of each batch compared
        self.kept: List[Tuple[int, dict]] = []
        self.next = 0

    def _serve(self, count=None, stop_at=None, keep=None):
        """Serve pool batches in turn until ``count`` are done or the clock
        passes ``stop_at``; returns (pool index, completion time) for each
        batch served, handing ``keep`` each one's host outputs too."""
        from aptai_tpu_torch.infer.api import fetch_outputs

        places = threading.Semaphore(self.run.params["ahead"])
        pending: "queue.Queue" = queue.Queue()
        errors: List[BaseException] = []

        def dispatch():
            k = 0
            try:
                while count is None or k < count:
                    places.acquire()
                    if stop_at is not None and time.perf_counter() >= stop_at:
                        break
                    i = self.next % len(self.pool)
                    self.next += 1
                    pending.put((i, self.served.predict_batch(
                        self.pool[i], fields=self.fields)))
                    k += 1
            except BaseException as e:  # the fetching side reports it
                errors.append(e)
            finally:
                pending.put(None)

        thread = threading.Thread(target=dispatch, daemon=True)
        thread.start()
        done = []
        try:
            while True:
                # the dispatching thread's own operations are not traced:
                # a gap here is the device waiting for predict_batch
                with record_function("port_bench.wait_for_dispatch"):
                    item = pending.get()
                if item is None:
                    break
                i, out = item
                with record_function("port_bench.fetch_outputs"):
                    host = fetch_outputs(out)
                t = time.perf_counter()
                if keep is not None:
                    keep(i, t, host)
                done.append((i, t))
                places.release()
        finally:
            thread.join()
        if errors:
            raise errors[0]
        return done

    def window(self, seconds):
        """Batches served until ``seconds`` have passed; the rate is the real
        audio of the batches completed in the window over the time from
        its start to the last of them."""
        t0 = time.perf_counter()
        stop_at = t0 + seconds
        self.served.host_s.clear()
        sample = WindowSample(self.run.params["check_batches"] - 1,
                              self.longest(), self.run.seed_for("check"),
                              stop_at)
        done = self._serve(stop_at=stop_at, keep=sample)
        self.kept = sample.batches()
        audio_s, flops, last = 0.0, 0, t0
        for i, t in done:
            if t > stop_at:
                continue
            lengths = [len(w) for w in self.pool[i]]
            audio_s += sum(lengths) / data.SAMPLE_RATE
            flops += serving.utterance_flops(self.run.cfg, lengths)
            last = max(last, t)
        elapsed = max(last - t0, 1e-9)
        self.obs.update({
            "attempted": sum(len(self.pool[i]) for i, _ in done),
            "failed": 0,
            "window_seconds": elapsed, "window_flops": flops,
            "host_s": list(self.served.host_s),
            "card": self._card()})
        return {"serve_audio_per_s": audio_s / elapsed}

    def _card(self):
        import torch

        return (torch.cuda.get_device_name(0) if self.run.device == "cuda"
                else "cpu")

    def traced(self):
        done = self._serve(count=self.run.params["trace_batches"])
        self.obs["traced_lengths"] = [len(w) for i, _ in done
                                      for w in self.pool[i]]
        self.obs["traced_units"] = len(done)

    def free(self):
        self.served.free()

    def longest(self) -> int:
        """The pool batch that holds the longest utterance."""
        return max(range(len(self.pool)),
                   key=lambda i: max(len(w) for w in self.pool[i]))

    def answers(self):
        """(the program's answer, the utterance) for each compared
        utterance, grouped by batch with the batch's width."""
        groups, got = [], []
        for i, host in self.kept:
            wavs = self.pool[i]
            groups.append((wavs, data.bucket(max(len(w) for w in wavs))))
            for b in range(len(wavs)):
                n = int(host["frame_lengths"][b])
                got.append({k: host[k][b, :n] for k in
                            ("tvs_pred", "phn_fc_logits")})
        return groups, got

    def check(self, control: bool = False):
        """The numbers compared; ``control``: the reference through fp8 in
        the program's place."""
        groups, got = self.answers()
        ref = serving.reference_answers(self.run, self.served.weights, groups)
        want = [a for answers in ref for a in answers]
        if control:
            got = [a for answers in serving.reference_answers(
                self.run, self.served.weights, groups, "fp8")
                for a in answers]
        return serving.serve_numbers(self.run, list(zip(got, want)))


class WindowSample:
    """The batches compared, kept as the window completes them: a uniform
    sample of ``k`` over every batch completed by ``stop_at`` (a reservoir,
    its draws from ``seed``), and the last completion of the pool batch
    ``longest``."""

    def __init__(self, k: int, longest: int, seed: int, stop_at: float):
        self.k, self.longest, self.stop_at = k, longest, stop_at
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.slots: List[Tuple[int, dict]] = []
        self.last_longest: Optional[Tuple[int, dict]] = None

    def __call__(self, i: int, t: float, host: dict) -> None:
        if t > self.stop_at:
            return
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append((i, host))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.slots[j] = (i, host)
        if i == self.longest:
            self.last_longest = (i, host)

    def batches(self) -> List[Tuple[int, dict]]:
        return self.slots + ([self.last_longest] if self.last_longest
                             else [])
