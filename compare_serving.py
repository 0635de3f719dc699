#!/usr/bin/env python3
"""Time the serving paths of one or more checkouts of this repository on
one NVIDIA GPU, in turns, in one command.

    python3 compare_serving.py OLD NEW NEW OLD OLD NEW NEW OLD
    python3 compare_serving.py --only ops NEW

Each argument is the root of a checkout (``.`` for this one). For each, in
the order given, a fresh process runs from that root: it builds the
kernels from that checkout's sources and, with random full-width weights
(wav2vec2-large, bf16, seed 0), times
  - W2V2PR ``encode_batch`` with the fused feature extractor at 32 x 10 s
    (chip_smoke phase 4b's batch), median of 10 batches;
  - APTAI ``predict_batch`` at 32 x 10 s (phase 4's), median of 10;
  - HTTP under load as phase 9b drives it: a ``ServingApp`` over the APTAI
    predictor (batch 16, 10 ms wait, the family's fields), the native
    transport, 256 requests of 1-10 s from 16 closed-loop clients, after
    64 requests of warm-up: requests/s and client latency p50/p95/p99.
In a checkout whose kernels are ``torch.library`` ops it also records
(``--only serving`` or ``--only ops`` runs one of the two lists)
  - the host time of one attention call at a request's shape (1, 16, 49,
    64) in inference mode, 2000 calls after 200, in turns: through
    ``multi_head_attention_bhtd``, the ``custom_op`` object, its
    ``OpOverload``, an op of the same schema registered with
    ``torch.library.Library`` and ``impl`` for ``CUDA`` alone, and the
    kernel's wrapper;
  - an APTAI serving bundle (``save_serving_bundle``, 16 x 10 s) beside
    the same program with its ``aten._assert_tensor_metadata`` nodes
    erased and beside the live predictor, on the same 16 waveforms:
    audio-s/s in turns bundle, stripped, live, live, stripped, bundle
    (median of 5 each), then one profiled batch of each: device kernel
    time against wall time, host-side aten calls, and the kernels and
    host ops whose time differs most between bundle and live.
Prints each turn's line, the mean per checkout, the card's name and power
limit, and last one JSON object with every turn's numbers. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from compare_kernels import card_line, run_turn

# run inside each checkout; imports that checkout's own modules, and only
# names that earlier checkouts have too
_TURN = r"""
import dataclasses
import json
import sys
import tempfile
import time
import numpy as np
import torch
import chip_smoke as cs
from aptai_tpu_torch.infer import APTAIPredictor, W2V2PRPredictor
from aptai_tpu_torch.infer.native_transport import make_native_server
from aptai_tpu_torch.infer.serve import KIND_FIELDS, ServingApp
from aptai_tpu_torch.infer.server import MicroBatcher
from aptai_tpu_torch.models import (Wav2Vec2Config, random_aptai,
                                    random_w2v2_pr)
from aptai_tpu_torch.ops import attention, kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build_all()
rng = np.random.default_rng(6)
wavs = [(rng.standard_normal(10 * cs.SAMPLE_RATE) * 0.1).astype(np.float32)
        for _ in range(32)]
cfg = Wav2Vec2Config(dtype="bfloat16")
parts = sys.argv[1].split(",")
turn = {}

def http_turn(pred, turn):
    batcher = MicroBatcher(pred.predict_batch, max_batch_size=16,
                           max_wait_ms=10.0, fields=KIND_FIELDS["aptai"],
                           fetch_workers=4)
    batcher.warmup(seconds=10.0)
    batcher.start()
    app = ServingApp(batcher, "aptai", vocab={f"p{i}": i for i in range(46)},
                     max_seconds=10.0, meta={}, streamer=None)
    srv = make_native_server(app, "127.0.0.1", 0)
    try:
        recording = cs.synthetic_recording(120.0, seed=1)
        rng = np.random.default_rng(0)
        secs = rng.uniform(1.0, 10.0, 320)
        starts = rng.integers(0, len(recording) - 10 * cs.SAMPLE_RATE, 320)
        reqs = [(recording[st:st + int(s * cs.SAMPLE_RATE)].tobytes(),
                 {"Content-Type": "application/octet-stream"})
                for s, st in zip(secs, starts)]
        cs.http_load(srv.port, reqs[256:])
        results, lat, wall = cs.http_load(srv.port, reqs[:256])
        if any(r is None or r[0] != 200 for r in results):
            raise AssertionError("a request failed")
        turn["http_requests_per_s"] = 256 / wall
        for q in (50, 95, 99):
            turn[f"http_p{q}_ms"] = float(np.percentile(lat, q) * 1e3)
    finally:
        srv.shutdown()
        batcher.stop()


def host_ops(prof):  # {op name: (calls, self CPU ms)} on the host
    return {e.key: (e.count, e.self_cpu_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("aten::")}


if "serving" in parts:
    pred = W2V2PRPredictor(random_w2v2_pr(
        dataclasses.replace(cfg, fused_feature_extractor=True), seed=0))
    times = cs.timed_batches(lambda: pred.encode_batch(wavs), n=10,
                             warmup=3)
    turn["w2v2_pr_fused_audio_s_per_s"] = 320 / float(np.median(times))
    del pred
    torch.cuda.empty_cache()

model = random_aptai(cfg, seed=0)
pred = APTAIPredictor(model)
if "serving" in parts:
    times = cs.timed_batches(lambda: pred.predict_batch(wavs), n=10,
                             warmup=3)
    turn["aptai_audio_s_per_s"] = 320 / float(np.median(times))
    http_turn(pred, turn)


if "ops" in parts and hasattr(attention, "flash_fwd"):  # library ops
    gen = torch.Generator("cuda").manual_seed(12)
    q, k, v = cs._qkv(gen, 1, 16, 49, torch.bfloat16, model_layout=True)
    lens = torch.tensor([49], dtype=torch.int32, device="cuda")
    lib = torch.library.Library("aptai_compare", "DEF")
    lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor lengths) "
               "-> Tensor")
    lib.impl("flash_fwd", attention.flash_attention_bhtd_cuda, "CUDA")
    library_op = torch.ops.aptai_compare.flash_fwd.default
    overload = torch.ops.aptai_torch.flash_fwd.default
    fns = {
        "mha": lambda: attention.multi_head_attention_bhtd(q, k, v, lens),
        "custom_op": lambda: attention.flash_fwd(q, k, v, lens),
        "overload": lambda: overload(q, k, v, lens),
        "library_impl": lambda: library_op(q, k, v, lens),
        "wrapper": lambda: attention.flash_attention_bhtd_cuda(q, k, v,
                                                               lens)}
    host = {who: [] for who in fns}
    with torch.inference_mode():
        for who in (*fns, *reversed(fns)):
            for _ in range(200):
                fns[who]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fns[who]()
            host[who].append((time.perf_counter() - t0) / 2000 * 1e6)
            torch.cuda.synchronize()
    for who, us in host.items():
        turn[f"host_us_{who}"] = sum(us) / len(us)

    from aptai_tpu_torch.infer.export import (load_serving_bundle,
                                              save_serving_bundle)
    with tempfile.TemporaryDirectory() as tmp:
        save_serving_bundle(tmp, model, batch=16, seconds=10.0,
                            fields=KIND_FIELDS["aptai"], kind="aptai")
        bundle = load_serving_bundle(tmp)
        # the same program without torch.export's dtype assertions (one
        # aten._assert_tensor_metadata a traced .to(); no value uses them)
        stripped = load_serving_bundle(tmp)
        graph = stripped._forward.graph
        asserts = [n for n in graph.nodes if n.op == "call_function"
                   and "_assert_tensor_metadata" in str(n.target)]
        for node in asserts:
            graph.erase_node(node)
        stripped._forward.recompile()
        turn["graph_nodes"] = len(bundle._forward.graph.nodes)
        turn["graph_asserts"] = len(asserts)
        big = wavs[:16]
        fns = {"bundle": lambda: bundle.predict_batch(big),
               "stripped": lambda: stripped.predict_batch(big),
               "live": lambda: pred.predict_batch(
                   big, fields=KIND_FIELDS["aptai"])}
        runs = {who: [] for who in fns}
        for who in (*fns, *reversed(fns)):
            runs[who].append(float(np.median(cs.timed_batches(
                fns[who], n=5, warmup=1))))
        for who, t in runs.items():
            turn[f"{who}_16x10_audio_s_per_s"] = 160 / (sum(t) / len(t))
        kern, host = {}, {}
        for who, fn in fns.items():
            busy, wall, prof = cs.profile_breakdown(fn, f"one {who} batch",
                                                    top=0)
            turn[f"{who}_kernel_ms"], turn[f"{who}_wall_ms"] = busy, wall
            kern[who] = {e.key: (e.count, e.self_device_time_total / 1e3)
                         for e in cs.device_kernels(prof)}
            host[who] = host_ops(prof)
            turn[f"{who}_host_op_calls"] = sum(c for c, _ in
                                               host[who].values())
        names = set(kern["bundle"]) | set(kern["live"])
        diff = sorted(names, key=lambda n: -abs(
            kern["bundle"].get(n, (0, 0.0))[1]
            - kern["live"].get(n, (0, 0.0))[1]))[:8]
        turn["kernels_bundle_vs_live"] = [
            [n[:90], *kern["bundle"].get(n, (0, 0.0)),
             *kern["live"].get(n, (0, 0.0))] for n in diff]
        names = set(host["bundle"]) | set(host["live"])
        diff = sorted(names, key=lambda n: -abs(
            host["bundle"].get(n, (0, 0.0))[1]
            - host["live"].get(n, (0, 0.0))[1]))[:8]
        turn["host_ops_bundle_vs_live"] = [
            [n[:90], *host["bundle"].get(n, (0, 0.0)),
             *host["live"].get(n, (0, 0.0))] for n in diff]
print("TURN " + json.dumps(turn))
"""

# (key, label, format) of the numbers each turn prints
_SHOWN = (("w2v2_pr_fused_audio_s_per_s", "W2V2PR fused FE audio-s/s", "{:.1f}"),
          ("aptai_audio_s_per_s", "APTAI audio-s/s", "{:.1f}"),
          ("http_requests_per_s", "HTTP requests/s", "{:.1f}"),
          ("http_p50_ms", "p50 ms", "{:.1f}"),
          ("http_p95_ms", "p95 ms", "{:.1f}"),
          ("http_p99_ms", "p99 ms", "{:.1f}"),
          ("host_us_mha", "host us: mha", "{:.1f}"),
          ("host_us_custom_op", "custom_op", "{:.1f}"),
          ("host_us_overload", "OpOverload", "{:.1f}"),
          ("host_us_library_impl", "Library.impl", "{:.1f}"),
          ("host_us_wrapper", "wrapper", "{:.1f}"),
          ("live_16x10_audio_s_per_s", "live 16 x 10 s audio-s/s", "{:.1f}"),
          ("bundle_16x10_audio_s_per_s", "bundle", "{:.1f}"),
          ("stripped_16x10_audio_s_per_s", "bundle without asserts",
           "{:.1f}"),
          ("graph_nodes", "graph nodes", "{:.0f}"),
          ("graph_asserts", "asserts", "{:.0f}"),
          ("live_kernel_ms", "live kernels ms", "{:.2f}"),
          ("live_wall_ms", "of wall", "{:.2f}"),
          ("live_host_op_calls", "host ops", "{:.0f}"),
          ("bundle_kernel_ms", "bundle kernels ms", "{:.2f}"),
          ("bundle_wall_ms", "of wall", "{:.2f}"),
          ("bundle_host_op_calls", "host ops", "{:.0f}"),
          ("stripped_kernel_ms", "without asserts kernels ms", "{:.2f}"),
          ("stripped_wall_ms", "of wall", "{:.2f}"),
          ("stripped_host_op_calls", "host ops", "{:.0f}"))


def _line(rec: dict) -> str:
    return ", ".join(f"{label} {fmt.format(rec[key])}"
                     for key, label, fmt in _SHOWN if key in rec)


PARTS = ("serving", "ops")


def main(argv) -> int:
    parts = PARTS
    if argv[:1] == ["--only"] and len(argv) > 1 and argv[1] in PARTS:
        parts, argv = (argv[1],), argv[2:]
    if not argv or any(a.startswith("-") for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in argv]
    turns = []
    for i, root in enumerate(roots):
        print(f"== turn {i + 1}: {root}", flush=True)
        rec = dict(run_turn(root, parts, snippet=_TURN, timeout=1200),
                   tree=str(root))
        turns.append(rec)
        print(f"  {_line(rec)}", flush=True)
        for key, what in (("kernels_bundle_vs_live", "device"),
                          ("host_ops_bundle_vs_live", "host self")):
            for row in rec.get(key, ()):
                print(f"    {what}: bundle {row[1]}x {row[2]:.3f} ms, live "
                      f"{row[3]}x {row[4]:.3f} ms: {row[0]}", flush=True)
    for root in dict.fromkeys(str(r) for r in roots):
        mine = [t for t in turns if t["tree"] == root]
        mean = {key: sum(t[key] for t in mine) / len(mine)
                for key, _, _ in _SHOWN if key in mine[0]}
        print(f"mean of {len(mine)} turn(s), {root}: {_line(mean)}")
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
