#!/usr/bin/env python3
"""Drive the PyTorch port (``aptai_tpu_torch``) on one NVIDIA GPU, end to end.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds every kernel of the serving path from ``csrc/``, one
   process per source, all started together.
2. Kernels against their plain versions on the card, at the shapes the
   serving path gives them (bf16, B=32, H=16, T=499, D=64, ragged lengths
   including 0 and 1; T=1100 for several key tiles; the float32 variant),
   then each kernel's time beside its bound, its plain version's time and a
   PyTorch library call's time as a yardstick.
3. The slice: a small float32 model on the card against the same model on
   the CPU; then full-width wav2vec2-large APTAI in bf16 (weights from seed
   0) served by the ``MicroBatcher`` on its background thread, 8 requests of
   1-10 s, with the kernel launch counts read around that run; then the
   same batch with attention forced to the plain version, which must agree.
4. Throughput: ``predict_batch`` at 32 x 10 s, audio-s/s and MFU, and a
   profiler breakdown of one batch by kernel.

Output: the phases' lines, then one JSON line of kernel records, the card
line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from aptai_tpu_torch.infer import APTAIPredictor, MicroBatcher
from aptai_tpu_torch.models import Wav2Vec2Config, random_aptai, tiny_config
from aptai_tpu_torch.models import wav2vec2 as w2v
from aptai_tpu_torch.ops import attention, kernels
from aptai_tpu_torch.utils.flops import (aptai_forward_flops,
                                         device_peak_tflops, mfu)

# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core peak, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SAMPLE_RATE = 16_000
BF16_TOL = 2e-2  # bf16 rounding of p before p.v, on unit-scale inputs


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2 ------------------------------------------------------------------

def _qkv(gen, b, h, t, dtype, model_layout):
    """Unit-scale q, k, v. ``model_layout``: (B, T, H, D) buffers viewed as
    (B, H, T, D), as the encoder's projections hand them over."""
    shape = (b, t, h, 64) if model_layout else (b, h, t, 64)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
          for _ in range(3)]
    return [x.transpose(1, 2) if model_layout else x for x in xs]


def check_kernel_case(name, q, k, v, lengths, tol):
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = attention.flash_attention_bhtd_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    want = attention.flash_attention_bhtd_plain(q, k, v, lens)
    err = (got.float() - want.float()).abs().max().item()
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    zero_ok = all(bool((got[i] == 0).all()) for i in zero_rows)
    log(f"  {name}: shape {tuple(q.shape)} {q.dtype} lengths "
        f"{sorted(set(lengths))[:6]}... max_abs_err {err:.3e} (tol {tol}) "
        f"zero rows exact: {zero_ok}")
    if not (err <= tol and zero_ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"flash kernel disagrees with plain: {name}")
    return err


def phase_kernels():
    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    b, h, t = 32, 16, 499
    ragged = [0, 1, t] + rng.integers(2, t + 1, b - 3).tolist()
    errs = [
        check_kernel_case("serving shape, model layout",
                          *_qkv(gen, b, h, t, torch.bfloat16, True),
                          ragged, BF16_TOL),
        check_kernel_case("serving shape, contiguous",
                          *_qkv(gen, b, h, t, torch.bfloat16, False),
                          ragged, BF16_TOL),
        check_kernel_case("T=1100, several key tiles",
                          *_qkv(gen, 2, h, 1100, torch.bfloat16, False),
                          [1100, 700], BF16_TOL),
    ]
    check_kernel_case("float32 variant",
                      *_qkv(gen, 4, 4, 300, torch.float32, True),
                      [300, 0, 1, 150], 1e-4)

    # times at the serving path's data: 32 x 10 s, every frame valid
    q, k, v = _qkv(gen, b, h, t, torch.bfloat16, True)
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: attention.flash_attention_bhtd_cuda(q, k, v, full),
                 50)
    plain_ms = cuda_ms(
        lambda: attention.flash_attention_bhtd_plain(q, k, v, full), 10)
    mask = (torch.arange(t, device="cuda")[None, :] < full[:, None])
    mask = mask[:, None, None, :]
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 50)
    lens = full.tolist()
    flops = 4 * h * 64 * t * sum(lens)          # q.k^T and p.v, valid keys
    nbytes = 2 * h * 64 * (2 * b * t + 2 * sum(lens))  # q, o; k, v to len
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S
                >= flops / PEAK_BF16_FLOPS else "operations")
    log(f"  flash_attn_fwd at B={b} H={h} T={t} D=64 bf16: {ms * 1e3:.1f} us "
        f"| plain {plain_ms * 1e3:.1f} us | sdpa {library_ms * 1e3:.1f} us "
        f"| bound {bound_ms * 1e3:.1f} us ({bound_by}) "
        f"| {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "aptai_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "aptai_tpu/ops/attention.py:64",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# -- phase 3 ------------------------------------------------------------------

def pearson(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def check_small_reference():
    """A small float32 model (head dim 64) on the card against the same
    weights on the CPU, which runs the plain attention."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256)
    model = random_aptai(cfg, seed=1, num_phonemes=46)
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_000, 31_000, 9_000)]
    cpu = APTAIPredictor(model, device="cpu").predict_batch(wavs)
    cpu = {k: v.numpy().copy() for k, v in cpu.items()}
    gpu = APTAIPredictor(model, device="cuda").predict_batch(wavs)
    gpu = {k: v.cpu().numpy() for k, v in gpu.items()}
    err_tv = float(np.abs(gpu["tvs_pred"] - cpu["tvs_pred"]).max())
    err_p = float(np.abs(gpu["phn_fc_probs"] - cpu["phn_fc_probs"]).max())
    log(f"  small f32 model, card vs CPU: tvs max_abs_err {err_tv:.2e}, "
        f"probs max_abs_err {err_p:.2e}")
    if not (np.array_equal(gpu["frame_lengths"], cpu["frame_lengths"])
            and err_tv <= 1e-3 and err_p <= 1e-4):
        raise AssertionError("the card disagrees with the CPU reference")


def check_result(res, n_samples, cfg):
    n = int(cfg.feat_extract_output_lengths(n_samples))
    tv, phn = res["tvs_pred"], res["phn_fc_pred"]
    probs = res["phn_fc_probs"]
    ok = (int(res["frame_lengths"]) == n and tv.shape == (n, 9)
          and phn.shape == (n,) and probs.shape == (n, 46)
          and np.isfinite(tv).all() and np.isfinite(probs).all())
    if not ok:
        raise AssertionError(f"bad result for a {n_samples}-sample request: "
                             f"frames {res['frame_lengths']}, tvs {tv.shape}")


def phase_slice(cfg, pred):
    log("== phase 3: the slice")
    check_small_reference()
    batches = []

    def serve(wavs, fields=None, real_rows=None):
        batches.append(len(wavs))
        return pred.predict_batch(wavs, fields=fields, real_rows=real_rows)

    rng = np.random.default_rng(0)
    seconds = (1.0, 10.0, 2.3, 4.7, 6.1, 7.9, 3.3, 8.6)
    wavs = [(rng.standard_normal(int(s * SAMPLE_RATE)) * 0.1).astype(
        np.float32) for s in seconds]
    mb = MicroBatcher(serve, max_batch_size=8, max_wait_ms=20.0)
    mb.warmup(seconds=10.0, cycles=1)
    batches.clear()

    attention.flash_attention_bhtd_cuda.launches = 0
    mb.start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(w) for w in wavs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        mb.stop()
    launches = attention.flash_attention_bhtd_cuda.launches

    for res, w in zip(results, wavs):
        check_result(res, len(w), cfg)
    log(f"  served {len(wavs)} requests ({sum(seconds):.1f} audio-s) in "
        f"{len(batches)} batch(es) of {batches} in {serve_s:.3f} s; "
        f"flash_attn_fwd launches {launches}")
    if launches != cfg.num_hidden_layers * len(batches) or launches == 0:
        raise AssertionError(f"expected {cfg.num_hidden_layers} launches per "
                             f"batch, got {launches} over {len(batches)}")

    kernel_out = mb.run_batch(wavs)
    w2v.multi_head_attention_bhtd = attention.flash_attention_bhtd_plain
    try:
        plain_out = mb.run_batch(wavs)
    finally:
        w2v.multi_head_attention_bhtd = attention.multi_head_attention_bhtd
    tv_k = np.concatenate([r["tvs_pred"] for r in kernel_out])
    tv_p = np.concatenate([r["tvs_pred"] for r in plain_out])
    rs = [pearson(tv_k[:, i], tv_p[:, i]) for i in range(9)]
    agree = float(np.mean(np.concatenate(
        [a["phn_fc_pred"] == b["phn_fc_pred"]
         for a, b in zip(kernel_out, plain_out)])))
    log(f"  kernel vs plain attention, same batch: per-TV Pearson min "
        f"{min(rs):.6f}, phoneme argmax agreement {agree:.4%}")
    if min(rs) < 0.999 or agree < 0.99:
        raise AssertionError("the slice through the kernel disagrees with "
                             "the plain attention")
    return launches


# -- phase 4 ------------------------------------------------------------------

def phase_throughput(cfg, pred, card):
    log("== phase 4: throughput, predict_batch at 32 x 10 s")
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    for _ in range(2):
        pred.predict_batch(wavs)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(wavs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    flops = 32 * aptai_forward_flops(cfg, 10 * SAMPLE_RATE)
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  batch times (s): {[round(x, 5) for x in times]}")
    log(f"  {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms per batch, "
        f"MFU {'not known for this card' if util is None else f'{util:.4f}'}"
        f" ({flops / 1e12:.2f} TFLOP per batch) on {card}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_batch(wavs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    log(f"  profiler, one batch: kernels {busy_ms:.2f} ms of {wall * 1e3:.2f} "
        f"ms wall (device idle {1 - busy_ms / (wall * 1e3):.1%}, profiler "
        f"on); top kernels:")
    for e in sorted(gpu, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:5d}x  {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: device and build")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    record = phase_kernels()

    cfg = Wav2Vec2Config(dtype="bfloat16")
    t0 = time.perf_counter()
    pred = APTAIPredictor(random_aptai(cfg, seed=0))
    log(f"  full-width APTAI (bf16, seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    record["launches"] = phase_slice(cfg, pred)
    phase_throughput(cfg, pred, card)

    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
