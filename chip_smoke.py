#!/usr/bin/env python3
"""Drive the PyTorch port (``aptai_tpu_torch``) on one NVIDIA GPU, end to end.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds every kernel from ``csrc/``, one process per source, all
   started together.
2. Kernels against their plain versions on the card: the flash forward (and
   its logsumexp) at the serving shape (bf16, B=32, H=16, T=499, D=64) and
   the forward, dq and dk/dv kernels at the training shape (B=8, H=16,
   T=249), with ragged lengths including 0 and 1, T=1100 for several tiles,
   and the float32 variants; then each kernel's time beside its bound, its
   plain version's time and a PyTorch library call's time as a yardstick.
3. Serving: a small float32 model on the card against the same model on
   the CPU; then full-width wav2vec2-large APTAI in bf16 (weights from seed
   0) served by the ``MicroBatcher`` on its background thread, 8 requests of
   1-10 s, with the kernel launch counts read around that run; then the
   same batch with attention forced to the plain version, which must agree.
4. Serving throughput: ``predict_batch`` at 32 x 10 s, audio-s/s and MFU,
   and a profiler breakdown of one batch by kernel.
5. Training: a small float32 model's train step on the card against the
   CPU; then the full-width bf16 APTAI train step (float32 masters, seed 0)
   at 8 x 5 s with dropout and SpecAugment on and the feature encoder
   frozen, with the kernel launch counts of one step, train audio-s/s, MFU,
   peak memory and a profile; the same batch without dropout through the
   kernels and through plain attention, whose gradients must agree; one
   step with ``remat_policy="full"``.

Output: the phases' lines, then one JSON line of kernel records, the card
line, and last ``{"ok": true, "device": {...}}``. A kernel record's
``launches`` is its count over one train step of phase 5, and
``launches_by_path`` holds each path's own count: the batches served in
phase 3 and that train step, each read with the counts set to 0 just before
it.
"""

from __future__ import annotations

import dataclasses
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
from aptai_tpu_torch.train import TrainStep, torch_adam
from aptai_tpu_torch.utils.flops import (aptai_forward_flops,
                                         device_peak_tflops, mfu,
                                         training_step_flops)

# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core peak, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SAMPLE_RATE = 16_000
# forward output: bf16 rounding of p before p.v, on unit-scale inputs
BF16_TOL = 2e-2
# backward outputs, relative to their largest magnitude: bf16 rounding of p
# and ds before their products and of the outputs; a rounding boundary
# falls differently when exp differs in its last bit
BF16_BWD_REL_TOL = 2e-2
F32_TOL = 1e-4  # float32 variants: summation order and exp/log ulps
LSE_TOL = 1e-3  # logsumexp of unit-scale scores, f32 in both versions
NO_DROP = dict(hidden_dropout=0.0, activation_dropout=0.0,
               attention_dropout=0.0, feat_proj_dropout=0.0)
COUNTED = {
    "flash_attn_fwd": attention.flash_attention_bhtd_cuda,
    "flash_attn_bwd_dq": attention.flash_attention_bwd_dq_cuda,
    "flash_attn_bwd_dkv": attention.flash_attention_bwd_dkv_cuda,
}


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


def device_ms(fn, iters: int = 20, name_part: str = "") -> float:
    """Device time per call of ``fn``: the profiler's sum over the CUDA
    kernels whose name contains ``name_part`` (all kernels by default),
    over ``iters`` calls. Unlike :func:`cuda_ms` it leaves out the gaps in
    which the card waits for the host to launch, which decide the time of
    a launch that takes a few tens of microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and name_part in e.key)
    if total_us <= 0:
        raise AssertionError(f"the profiler saw no kernel {name_part!r}")
    return total_us / iters / 1e3


def reset_counts():
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2 ------------------------------------------------------------------

def _qkv(gen, b, h, t, dtype, model_layout, n=3):
    """Unit-scale (B, H, T, 64) tensors. ``model_layout``: (B, T, H, D)
    buffers viewed as (B, H, T, D), as the encoder's projections (and the
    gradient of the output projection) hand them over."""
    shape = (b, t, h, 64) if model_layout else (b, h, t, 64)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
          for _ in range(n)]
    return [x.transpose(1, 2) if model_layout else x for x in xs]


def _rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_kernel_case(name, q, k, v, dout, lengths, backward=True):
    """The forward (output and logsumexp) and, with ``backward``, the dq
    and dk/dv kernels against their plain versions on the same inputs.
    Returns the max abs errors {kernel: err}."""
    bf16 = q.dtype == torch.bfloat16
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                   return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = attention.flash_attention_bhtd_plain(
        q, k, v, lens, return_lse=True)
    errs = {"flash_attn_fwd": _rel_err(got, want)[0]}
    lse_err = (lse - want_lse).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    ok = (errs["flash_attn_fwd"] <= (BF16_TOL if bf16 else F32_TOL)
          and lse_err <= LSE_TOL
          and torch.equal(torch.isinf(lse), torch.isinf(want_lse))
          and torch.isfinite(got.float()).all().item())
    outs = [got]
    rel = {}
    if backward:
        delta = attention.attention_delta(got, dout)
        dq = attention.flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                                   lens)
        dk, dv = attention.flash_attention_bwd_dkv_cuda(q, k, v, dout, lse,
                                                        delta, lens)
        torch.cuda.synchronize()
        pq, pk, pv = attention.flash_attention_bhtd_bwd_plain(
            q, k, v, got, lse, dout, lens)
        tol = BF16_BWD_REL_TOL if bf16 else F32_TOL
        for kname, pairs in (("flash_attn_bwd_dq", ((dq, pq),)),
                             ("flash_attn_bwd_dkv", ((dk, pk), (dv, pv)))):
            pair_errs = [_rel_err(g, w) for g, w in pairs]
            errs[kname] = max(e for e, _ in pair_errs)
            rel[kname] = max(r for _, r in pair_errs)
            ok = ok and rel[kname] <= tol
        outs += [dq, dk, dv]
        ok = ok and all(torch.isfinite(x.float()).all().item() for x in outs)
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    zero_ok = all(bool((x[i] == 0).all()) for x in outs for i in zero_rows)
    log(f"  {name}: shape {tuple(q.shape)} {q.dtype} lengths "
        f"{sorted(set(lengths))[:6]}... fwd max_abs_err "
        f"{errs['flash_attn_fwd']:.3e}, lse {lse_err:.3e}"
        + "".join(f", {n[15:]} max_abs_err {errs[n]:.3e} (rel {rel[n]:.3e})"
                  for n in rel)
        + f"; zero-length rows exactly 0: {zero_ok}")
    if not (ok and zero_ok):
        raise AssertionError(f"a flash kernel disagrees with its plain "
                             f"version: {name}")
    return errs


def time_forward(gen):
    """The forward at the serving path's data: 32 x 10 s, every frame
    valid (PR 1's measurement, kept for comparison)."""
    b, h, t = 32, 16, 499
    q, k, v = _qkv(gen, b, h, t, torch.bfloat16, True)
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: attention.flash_attention_bhtd_cuda(q, k, v, full),
                 50)
    plain_ms = cuda_ms(
        lambda: attention.flash_attention_bhtd_plain(q, k, v, full), 10)
    mask = (torch.arange(t, device="cuda")[None, :] < full[:, None])
    mask = mask[:, None, None, :]
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 50)
    n = sum(full.tolist())
    flops = 4 * h * 64 * t * n                  # q.k^T and p.v, valid keys
    nbytes = 2 * h * 64 * (2 * b * t + 2 * n)   # q, o; k, v to the length
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  flash_attn_fwd at B={b} H={h} T={t} D=64 bf16: {ms * 1e3:.1f} us "
        f"| plain {plain_ms * 1e3:.1f} us | sdpa {library_ms * 1e3:.1f} us "
        f"| bound {bound_ms * 1e3:.1f} us ({bound_by}) "
        f"| {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def time_training_kernels(gen, lengths):
    """The forward with its logsumexp and the two backward kernels at the
    training shape (B=8, H=16, T=249) with the training batch's
    ``lengths``; the SDPA forward + backward on the same masked problem
    as the yardstick of the three together. Device times from the
    profiler; each launch's wall time (CUDA events over back-to-back
    calls, host launch gaps included) beside them."""
    b, h, t = len(lengths), 16, 249
    q, k, v, do = _qkv(gen, b, h, t, torch.bfloat16, True, n=4)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                 return_lse=True)
    delta = attention.attention_delta(o, do)
    calls = {
        "fwd": lambda: attention.flash_attention_bhtd_cuda(
            q, k, v, lens, return_lse=True),
        "dq": lambda: attention.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta, lens),
        "dkv": lambda: attention.flash_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta, lens),
    }
    names = {"fwd": "flash_fwd_bf16", "dq": "flash_bwd_dq_bf16",
             "dkv": "flash_bwd_dkv_bf16"}
    dev = {n: device_ms(fn, 50, names[n]) for n, fn in calls.items()}
    wall = {n: cuda_ms(fn, 50) for n, fn in calls.items()}
    fwd_ms, dq_ms, dkv_ms = dev["fwd"], dev["dq"], dev["dkv"]
    delta_ms = device_ms(lambda: attention.attention_delta(o, do), 50)
    plain_bwd_ms = device_ms(lambda: attention.flash_attention_bhtd_bwd_plain(
        q, k, v, o, lse, do, lens), 10)
    ours_ms = device_ms(lambda: attention.flash_attention_bwd_cuda(
        q, k, v, *attention.flash_attention_bhtd_cuda(
            q, k, v, lens, return_lse=True), do, lens), 50)

    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)
        return torch.autograd.grad(out, (qs, ks, vs), do)

    sdpa_ms = device_ms(sdpa_fwd_bwd, 50)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask)
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True), 50)

    n = sum(min(x, t) for x in lengths)   # valid keys over the batch
    tile = h * 64 * 2                     # bytes of one bf16 row of all heads
    rows = 2 * h * 4                      # lse and delta, f32, all heads
    records = {}
    for name, ms, mults, nbytes in (
            # q.k^T, dO.v^T, ds.k; reads q, dO, lse, delta (T rows), k, v
            # (to the length); writes dq
            ("flash_attn_bwd_dq", dq_ms, 6,
             tile * (3 * b * t + 2 * n) + rows * b * t),
            # q.k^T, dO.v^T, p^T.dO, ds^T.q; reads q, dO, lse, delta, k, v;
            # writes dk, dv
            ("flash_attn_bwd_dkv", dkv_ms, 8,
             tile * (4 * b * t + 2 * n) + rows * b * t)):
        bound_ms, bound_by = bound(mults * h * 64 * t * n, nbytes)
        records[name] = {
            "ms": ms, "plain_ms": plain_bwd_ms,
            "plain_covers": "dq, dk and dv: the whole plain backward",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_bwd_ms,
            "library_covers": "dq, dk and dv: the backward of "
                              "scaled_dot_product_attention, its delta "
                              "included"}
    fwd_bound_ms, _ = bound(4 * h * 64 * t * n,
                            tile * (2 * b * t + 2 * n) + 4 * h * b * t)
    log(f"  at B={b} H={h} T={t} D=64 bf16 (lengths {sorted(set(lengths))}):"
        f" flash_attn_fwd+lse {fwd_ms * 1e3:.1f} us (bound "
        f"{fwd_bound_ms * 1e3:.1f} us); dq {dq_ms * 1e3:.1f} us (bound "
        f"{records['flash_attn_bwd_dq']['bound_ms'] * 1e3:.1f} us, "
        f"{records['flash_attn_bwd_dq']['bound_by']}); dk/dv "
        f"{dkv_ms * 1e3:.1f} us (bound "
        f"{records['flash_attn_bwd_dkv']['bound_ms'] * 1e3:.1f} us, "
        f"{records['flash_attn_bwd_dkv']['bound_by']}); delta "
        f"{delta_ms * 1e3:.1f} us; plain backward {plain_bwd_ms * 1e3:.1f} us"
        f" (device times); a launch's wall time, back to back: fwd+lse "
        f"{wall['fwd'] * 1e3:.1f} us, dq {wall['dq'] * 1e3:.1f} us, dk/dv "
        f"{wall['dkv'] * 1e3:.1f} us")
    log(f"  forward + backward, same masked problem, device time: ours "
        f"{ours_ms * 1e3:.1f} us (fwd+lse, delta, dq, dk/dv) | sdpa "
        f"{sdpa_ms * 1e3:.1f} us (of which its backward {sdpa_bwd_ms * 1e3:.1f}"
        f" us) | ratio {ours_ms / sdpa_ms:.2f}")
    return records, fwd_ms


def phase_kernels(train_lengths):
    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    b, h, t = 32, 16, 499
    ragged = [0, 1, t] + rng.integers(2, t + 1, b - 3).tolist()
    ragged_train = [0, 1, 249] + rng.integers(2, 250, 5).tolist()
    cases = [
        ("serving shape, model layout", (b, h, t, torch.bfloat16, True),
         ragged),
        ("serving shape, contiguous", (b, h, t, torch.bfloat16, False),
         ragged),
        ("training shape, model layout", (8, h, 249, torch.bfloat16, True),
         ragged_train),
        ("training shape, batch lengths", (8, h, 249, torch.bfloat16, True),
         train_lengths),
        ("T=1100, several tiles", (2, h, 1100, torch.bfloat16, False),
         [1100, 700]),
        ("float32 variant", (4, 4, 300, torch.float32, True),
         [300, 0, 1, 150]),
        ("float32 variant, T=1100", (2, 2, 1100, torch.float32, False),
         [1100, 65]),
    ]
    errs = {name: 0.0 for name in COUNTED}
    for name, (bb, hh, tt, dtype, layout), lengths in cases:
        q, k, v, do = _qkv(gen, bb, hh, tt, dtype, layout, n=4)
        for kname, err in check_kernel_case(name, q, k, v, do,
                                            lengths).items():
            errs[kname] = max(errs[kname], err)

    records = {"flash_attn_fwd": time_forward(gen)}
    train_records, fwd_lse_ms = time_training_kernels(gen, train_lengths)
    records.update(train_records)
    replaces = {"flash_attn_fwd": ("flash_attn_fwd.cu", 64),
                "flash_attn_bwd_dq": ("flash_attn_bwd.cu", 170),
                "flash_attn_bwd_dkv": ("flash_attn_bwd.cu", 216)}
    out = []
    for name, rec in records.items():
        src, line = replaces[name]
        out.append({"name": name, "route": "cuda",
                     "source": f"aptai_tpu_torch/csrc/{src}",
                     "replaces": f"aptai_tpu/ops/attention.py:{line}",
                     "launches": None, "launches_by_path": None,
                     "max_abs_err": errs[name], **rec})
    return out


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
    log("== phase 3: serving")
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

    reset_counts()
    mb.start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(w) for w in wavs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        mb.stop()
    counts = read_counts()
    launches = counts["flash_attn_fwd"]
    n_batches = len(batches)

    for res, w in zip(results, wavs):
        check_result(res, len(w), cfg)
    log(f"  served {len(wavs)} requests ({sum(seconds):.1f} audio-s) in "
        f"{n_batches} batch(es) of {batches} in {serve_s:.3f} s; "
        f"launches {counts}")
    if (launches != cfg.num_hidden_layers * n_batches or launches == 0
            or counts["flash_attn_bwd_dq"] or counts["flash_attn_bwd_dkv"]):
        raise AssertionError(f"expected {cfg.num_hidden_layers} forward "
                             f"launches per batch and no backward, got "
                             f"{counts} over {n_batches} batch(es)")

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
    return counts, n_batches


# -- phase 4 ------------------------------------------------------------------

def profile_breakdown(fn, what: str, top: int = 15):
    """One profiled call of ``fn``: device kernel time against wall time,
    and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    log(f"  profiler, {what}: kernels {busy_ms:.2f} ms of {wall * 1e3:.2f} "
        f"ms wall (device idle {1 - busy_ms / (wall * 1e3):.1%}, profiler "
        f"on); top kernels:")
    for e in sorted(gpu, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:5d}x  {e.key[:100]}")


def phase_throughput(cfg, pred, card):
    log("== phase 4: serving throughput, predict_batch at 32 x 10 s")
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
    profile_breakdown(lambda: pred.predict_batch(wavs), "one batch")


# -- phase 5 ------------------------------------------------------------------

def train_batch(cfg, b: int = 8, seconds: int = 5, seed: int = 0):
    """The JAX package's training benchmark batch: b x ``seconds`` of
    noise, every frame valid, random phoneme ids 1-45 and TV targets."""
    rng = np.random.default_rng(seed)
    samples = seconds * SAMPLE_RATE
    t = int(cfg.feat_extract_output_lengths(samples))
    return {
        "audio": (rng.standard_normal((b, samples)) * 0.1).astype(np.float32),
        "audio_lengths": np.full(b, samples, np.int32),
        "phn_frames": rng.integers(1, 46, (b, t)).astype(np.int32),
        "tv_targets": rng.standard_normal((b, t, 9)).astype(np.float32),
    }


def flat_grads(model, prefix=""):
    """{name: grad} of the parameters under ``prefix`` that have one, and
    their concatenation (float32, on the parameters' device)."""
    named = {n: p.grad.detach() for n, p in model.named_parameters()
             if p.grad is not None and n.startswith(prefix)}
    return named, torch.cat([g.float().flatten() for g in named.values()])


def compare_grads(what, named_a, flat_a, named_b, flat_b, max_rel, min_cos):
    if set(named_a) != set(named_b):
        raise AssertionError(f"{what}: different parameters have gradients")
    flat_b = flat_b.to(flat_a.device)
    rel = ((flat_a - flat_b).norm() / flat_b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(flat_a, flat_b, dim=0).item()
    worst = max(named_b, key=lambda n: (
        (named_a[n].float() - named_b[n].float().to(flat_a.device)).norm()
        / named_b[n].float().norm().clamp(min=1e-30)).item())
    log(f"  {what}: {len(named_a)} gradients, relative L2 {rel:.3e} "
        f"(bound {max_rel}), cosine {cos:.6f} (bound {min_cos}); worst "
        f"tensor {worst}")
    if not (rel <= max_rel and cos >= min_cos):
        raise AssertionError(f"{what}: gradients disagree")


def check_small_train_reference():
    """A small float32 model's train step (head dim 64, dropout and
    SpecAugment off) on the card against the same step on the CPU, which
    runs the plain attention forward and backward."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, mask_time_prob=0.0, **NO_DROP)
    batch = train_batch(cfg, b=3, seconds=1, seed=3)
    batch["audio_lengths"] = np.array([16_000, 11_000, 6_000], np.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = random_aptai(cfg, seed=1, tv_drop=0.0, phn_drop=0.0)
        step = TrainStep(model, torch_adam(model), device=dev)
        loss = step(batch, 1e-3)["loss"].item()
        runs[dev] = (loss,) + flat_grads(model)
    (lc, gc, fc), (lg, gg, fg) = runs["cpu"], runs["cuda"]
    log(f"  small f32 train step, card vs CPU: loss {lg:.6f} vs {lc:.6f}")
    if not (np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
        raise AssertionError("the card's loss disagrees with the CPU's")
    # float32 in both: only summation order and exp ulps differ
    compare_grads("small f32 train step, card vs CPU", gg, fg, gc, fc,
                  max_rel=1e-4, min_cos=0.99999999)


def timed_steps(step, batch, n: int):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch, 1e-5)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, m


def phase_train(card):
    log("== phase 5: the train step at 8 x 5 s")
    check_small_train_reference()

    cfg = Wav2Vec2Config(dtype="bfloat16")
    batch = train_batch(cfg)
    b, samples = batch["audio"].shape
    model = random_aptai(cfg, seed=0)
    fe_prefix = "wav2vec2.feature_extractor."
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, torch_adam(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    loss0 = step(batch, 1e-5)["loss"].item()
    counts = read_counts()
    log(f"  first step: loss {loss0:.5f}, launches {counts}")
    want = cfg.num_hidden_layers
    if not (np.isfinite(loss0) and all(c == want for c in counts.values())):
        raise AssertionError(f"expected {want} launches of each kernel per "
                             f"step and a finite loss, got {counts}, {loss0}")

    timed_steps(step, batch, 1)  # the second warm-up step
    reset_counts()
    times, m = timed_steps(step, batch, 5)
    counts5 = read_counts()
    sec = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = training_step_flops(b * aptai_forward_flops(cfg, samples))
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  step times (s): {[round(x, 5) for x in times]}; launches over "
        f"them {counts5}; last loss {m['loss'].item():.5f}")
    log(f"  {b * samples / SAMPLE_RATE / sec:.1f} train audio-s/s, "
        f"{sec * 1e3:.2f} ms per step, MFU "
        f"{'not known for this card' if util is None else f'{util:.4f}'} "
        f"({flops / 1e12:.2f} TFLOP per step, 3x forward) on {card}; peak "
        f"memory {peak:.2f} GiB")
    if any(c != 5 * want for c in counts5.values()):
        raise AssertionError(f"launches over 5 steps: {counts5}")
    profile_breakdown(lambda: step(batch, 1e-5), "one train step", top=20)

    unchanged = [n for n, p in model.named_parameters()
                 if not n.startswith(fe_prefix)
                 and torch.equal(p.detach().cpu(), before[n])]
    fe_same = all(torch.equal(p.detach().cpu(), before[n])
                  for n, p in model.named_parameters()
                  if n.startswith(fe_prefix))
    log(f"  after {step.step_count} steps: feature encoder bit-identical "
        f"{fe_same}; trainable tensors unchanged: {unchanged}")
    if not fe_same or unchanged:
        raise AssertionError("the frozen feature encoder moved, or a "
                             "trainable parameter did not")
    del before

    # the same batch, no dropout or SpecAugment, kernels vs plain attention
    model.eval()
    tensors = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        out = model(tensors["audio"], tensors["audio_lengths"],
                    tensors["phn_frames"], tensors["tv_targets"])
        out["loss"].backward()
        return (out["loss"].item(),) + flat_grads(model, "wav2vec2.")

    reset_counts()
    lk, gk, fk = loss_and_grads()
    counts_k = read_counts()
    w2v.multi_head_attention_bhtd = attention.flash_attention_bhtd_plain
    try:
        reset_counts()
        lp, gp, fp = loss_and_grads()
        counts_p = read_counts()
    finally:
        w2v.multi_head_attention_bhtd = attention.multi_head_attention_bhtd
    log(f"  no dropout, kernels vs plain attention (autograd): loss "
        f"{lk:.6f} vs {lp:.6f}; launches {counts_k} vs {counts_p}")
    if any(counts_p.values()) or any(c != want for c in counts_k.values()):
        raise AssertionError("the kernel and plain runs took the wrong path")
    # bf16 activations round at other points in the two versions (the
    # kernel rounds p and ds; plain autograd rounds its own intermediates)
    # and 24 layers compound the differences
    compare_grads("encoder gradients, kernels vs plain", gk, fk, gp, fp,
                  max_rel=0.1, min_cos=0.99)
    del gk, fk, gp, fp, step, model
    torch.cuda.empty_cache()

    # one step with per-layer recomputation: the forward runs twice
    model = random_aptai(dataclasses.replace(cfg, remat_policy="full"),
                         seed=0)
    step = TrainStep(model, torch_adam(model))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss_full = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    counts_full = read_counts()
    log(f"  remat_policy='full': first step loss {loss_full:.5f} (none: "
        f"{loss0:.5f}), launches {counts_full}, {full_s * 1e3:.1f} ms "
        f"(with warm-up), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (counts_full["flash_attn_fwd"] == 2 * want
            and counts_full["flash_attn_bwd_dq"] == want
            and counts_full["flash_attn_bwd_dkv"] == want
            and abs(loss_full - loss0) <= 1e-3 * abs(loss0)):
        raise AssertionError("the remat step took the wrong path or loss")
    return {name: counts[name] for name in COUNTED}


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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {name}: {line.strip()}")

    cfg = Wav2Vec2Config(dtype="bfloat16")
    train_lengths = train_batch(cfg)["audio_lengths"]
    train_lengths = cfg.feat_extract_output_lengths(train_lengths).tolist()
    records = phase_kernels(train_lengths)
    t0 = time.perf_counter()
    pred = APTAIPredictor(random_aptai(cfg, seed=0))
    log(f"  full-width APTAI (bf16, seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    serving, n_batches = phase_slice(cfg, pred)
    phase_throughput(cfg, pred, card)
    del pred
    torch.cuda.empty_cache()
    training = phase_train(card)
    for rec in records:
        rec["launches"] = training[rec["name"]]
        rec["launches_by_path"] = {
            "serving": {"batches": n_batches,
                        "launches": serving[rec["name"]]},
            "train_step": {"steps": 1, "launches": training[rec["name"]]}}

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
