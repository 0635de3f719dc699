#!/usr/bin/env python3
"""Time the hand-written kernels of one or more checkouts of this
repository on one NVIDIA GPU, in turns, in one command.

    python3 compare_kernels.py OLD NEW NEW OLD
    python3 compare_kernels.py --only fused_conv OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one). For each, in
the order given, a fresh process runs from that root: it builds the
kernels from that checkout's sources, and times by the profiler's device
time
  - the fused conv + LayerNorm + GELU at each of the six feature-extractor
    layers it serves in a 32 x 10 s batch (bf16, C 512), each output first
    held against the plain version (one bf16 ulp + 1e-5);
  - the forward at the serving shape (B=32, H=16, T=499, D=64, bf16, every
    frame valid, the (B, T, H, D) layout the projections hand over), beside
    SDPA with the same boolean mask and without one;
  - at the training shape (B=8, H=16, T=249, bf16, the training batch's
    lengths), through that checkout's ``chip_smoke.time_training_kernels``:
    the forward with its logsumexp, dq and dk/dv, beside SDPA's forward and
    backward; and one call of ``flash_attention_bwd_cuda``, every kernel it
    launches (Δ included, wherever it is computed).
``--only attention`` or ``--only fused_conv`` times one family. Prints each
turn's line, then the mean per checkout, the card's name and power limit,
and last one JSON object with every turn's numbers. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

# run inside each checkout; imports that checkout's own modules, and only
# names that earlier checkouts have too
_TURN = r"""
import json
import sys
import torch
import chip_smoke as cs
from aptai_tpu_torch.models import Wav2Vec2Config
from aptai_tpu_torch.ops import attention, fused_conv, kernels

parts = sys.argv[1].split(",")
gen = torch.Generator(device="cuda").manual_seed(0)
turn = {}
if "fused_conv" in parts:
    kernels.build_all(["fused_conv_ln_gelu"])
    worst = 0.0
    for i, (length, k) in enumerate(zip(cs.fe_input_lengths(),
                                        (3, 3, 3, 3, 2, 2)), start=1):
        x, w, bb, ln_w, ln_b = cs.fused_operands(gen, 32, length, 512, 512, k,
                                                 torch.bfloat16)
        got = fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b, 2)
        want = fused_conv.fused_conv_ln_gelu_plain(x, w, bb, ln_w, ln_b, 2)
        err = (got.float() - want.float()).abs()
        if not bool((err <= cs.bf16_ulp(want) + 1e-5).all()):
            raise AssertionError(f"fused conv layer {i} disagrees with plain")
        worst = max(worst, err.max().item())
        del got, want, err
        turn[f"fused_layer{i}_ms"] = cs.device_ms(
            lambda: fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b,
                                                       2),
            20, "fused_conv_ln_gelu_bf16")
        del x
    turn["fused_total_ms"] = sum(turn[f"fused_layer{i}_ms"]
                                 for i in range(1, 7))
    turn["fused_max_abs_err"] = worst

if "attention" in parts:
    kernels.build_all(["flash_attn_fwd", "flash_attn_bwd"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, t = 32, 16, 499
    q, k, v = cs._qkv(gen, b, h, t, torch.bfloat16, True)
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    mask = torch.ones((b, 1, 1, t), dtype=torch.bool, device="cuda")
    turn["fwd_serving_ms"] = cs.device_ms(
        lambda: attention.flash_attention_bhtd_cuda(q, k, v, full), 50,
        "flash_fwd_bf16")
    turn["sdpa_masked_serving_ms"] = cs.device_ms(
        lambda: sdpa(q, k, v, attn_mask=mask), 50)
    turn["sdpa_unmasked_serving_ms"] = cs.device_ms(lambda: sdpa(q, k, v), 50)
    del q, k, v

    cfg = Wav2Vec2Config(dtype="bfloat16")
    lengths = cfg.feat_extract_output_lengths(
        cs.train_batch(cfg)["audio_lengths"]).tolist()
    records, fwd = cs.time_training_kernels(gen, lengths)
    b, h, t = len(lengths), 16, 249
    q, k, v, do = cs._qkv(gen, b, h, t, torch.bfloat16, True, n=4)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                 return_lse=True)
    bwd_ms = cs.device_ms(lambda: attention.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, lens), 50)
    dq, dkv = records["flash_attn_bwd_dq"], records["flash_attn_bwd_dkv"]
    turn.update(
        fwd_training_ms=fwd["ms"], sdpa_fwd_training_ms=fwd["library_ms"],
        dq_ms=dq["ms"], dkv_ms=dkv["ms"], backward_ms=bwd_ms,
        sdpa_backward_ms=dq["library_ms"], dq_bound_ms=dq["bound_ms"],
        dkv_bound_ms=dkv["bound_ms"])
print("TURN " + json.dumps(turn))
"""

# (key, label) of the numbers each turn prints, all device times
_SHOWN = (*((f"fused_layer{i}_ms", f"fused conv layer {i}")
             for i in range(1, 7)),
          ("fused_total_ms", "fused conv, six layers"),
          ("fwd_serving_ms", "forward at 32 x 499"),
          ("sdpa_masked_serving_ms", "sdpa masked"),
          ("sdpa_unmasked_serving_ms", "sdpa unmasked"),
          ("fwd_training_ms", "forward+lse at 8 x 249"),
          ("sdpa_fwd_training_ms", "sdpa forward"),
          ("dq_ms", "dq"), ("dkv_ms", "dk/dv"),
          ("backward_ms", "the whole backward call"),
          ("sdpa_backward_ms", "sdpa backward"))


PARTS = ("fused_conv", "attention")


def _line(rec: dict) -> str:
    return ", ".join(f"{label} {rec[key] * 1e3:.1f} us"
                     for key, label in _SHOWN if key in rec)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def run_turn(root: Path, parts=PARTS, snippet: str = _TURN,
             timeout: float = 900) -> dict:
    """Run ``snippet`` in a fresh process from the checkout ``root`` (with
    ``parts`` as its argument) and return the JSON of its ``TURN`` line."""
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", snippet, ",".join(parts)],
                         cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    for line in res.stdout.splitlines():
        if not line.startswith("TURN "):
            print(f"    {line}", flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"the turn in {root} failed:\n{res.stderr}")
    return json.loads(res.stdout.split("TURN ", 1)[1].splitlines()[0])


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
        rec = dict(run_turn(root, parts), tree=str(root))
        turns.append(rec)
        print(f"  {_line(rec)} (device times)", flush=True)
    for root in dict.fromkeys(str(r) for r in roots):
        mine = [t for t in turns if t["tree"] == root]
        mean = {key: sum(t[key] for t in mine) / len(mine)
                for key, _ in _SHOWN if key in mine[0]}
        print(f"mean of {len(mine)} turn(s), {root}: {_line(mean)}")
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
