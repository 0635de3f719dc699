"""The traced segment: the kind's ``traced()`` under ``torch.profiler``, and
the reduction of the device trace to what the per-layer readers read.

* ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device (overlapping operations count once); ``window_s``: the
  traced segment's wall time; the idle share is 1 - busy / window.
* ``kernels``: device seconds and launches by kernel name.
* ``breakdown``: the ten device operations that took most time, and the
  idle gaps named by what the host was doing (the innermost benchmark span
  and CUDA runtime call open at the middle of the gap), summed by that
  name, the ten largest.

The profiler writes its chrome trace to a file under ``TMPDIR``, which is
read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what names an idle gap: the benchmark's spans (on the host, or as the
# profiler mirrors them on the device's timeline) and the CUDA runtime
# call the host was in
SPAN_CATS = ("user_annotation", "gpu_user_annotation")
HOST_CATS = SPAN_CATS + ("cuda_runtime", "cpu_op")


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def host_names(host: List[Tuple[float, float, str, str]],
               times: List[float]) -> List[str]:
    """For each of ``times`` (ascending), the innermost benchmark span and
    host operation open then: one sweep over the host events by start."""
    host = sorted(host)
    names, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        span = min((h for h in active if h[2] in SPAN_CATS),
                   key=lambda h: h[1] - h[0], default=None)
        op = min((h for h in active if h[2] not in SPAN_CATS),
                 key=lambda h: h[1] - h[0], default=None)
        names.append(" / ".join(h[3] for h in (span, op) if h)
                     or "no host operation")
    return names


def reduce_events(events: List[dict], t0: float, t1: float) -> Dict:
    """The trace's device and host events (times in microseconds) to
    ``busy_s``, ``kernels`` and ``breakdown`` over the window [t0, t1]."""
    dev, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            rec = kernels[e["name"]]
            rec[0] += d * 1e-6
            rec[1] += 1
        elif cat in HOST_CATS:
            host.append((s, s + d, cat, e["name"]))
    busy = merged(dev)
    gaps = []
    edge = t0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    by_host: Dict[str, float] = defaultdict(float)
    for (s, e), name in zip(gaps, host_names(host, [(s + e) / 2
                                                    for s, e in gaps])):
        by_host[name] += (e - s) * 1e-6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": union_seconds(dev) * 1e-6,
        "kernels": {k: {"seconds": v[0], "launches": v[1]}
                    for k, v in kernels.items()},
        "breakdown": {
            "device_ops": [[k[:200], v[0]] for k, v in top_ops],
            "idle_gaps": [[k[:200], v] for k, v in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def traced_segment(kind) -> None:
    """Run ``kind.traced()`` under the profiler and add the reduced trace to
    ``kind.obs``; ``window_s`` is the segment's wall time, from the
    profiler's start to the device's last operation of the segment."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # on the card the device's activity alone: recording every host
    # operation too doubled a training step's host time (PR 24's runs),
    # and with it the idle share
    activities = [ProfilerActivity.CPU]
    if kind.run.device == "cuda":
        activities = [ProfilerActivity.CUDA]
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t_start = time.perf_counter()
        kind.traced()
        if kind.run.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") in
             HOST_CATS + DEVICE_CATS and "dur" in e]
    t0 = min((float(e["ts"]) for e in spans), default=0.0)
    t1 = t0 + window_s * 1e6
    kind.obs.update(reduce_events(events, t0, t1))
    kind.obs["window_s"] = window_s
