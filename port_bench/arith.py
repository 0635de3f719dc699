"""The yardstick's arithmetic: model FLOPs, kernel operations and bytes, and
the card's peaks.

The model FLOP count is copied from ``aptai_tpu_torch/utils/flops.py`` (a
multiply-accumulate counts 2; useful work at each utterance's true length,
not the padded work the card runs; elementwise work left out; a training
step is 3x the forward). The bound is ``chip_smoke.py``'s: the least time
the card could take is the larger of operations over the peak rate and
bytes over the memory rate. The copies live here so that a change to the
program cannot move the yardstick.

Configurations are plain dicts with the keys of ``configs/<name>.json``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W; the
# SXM part names itself "H100 80GB HBM3"
PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks(card_name: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by its name; None for a card not in the table
    (no roofline or MFU is then reported)."""
    for key, value in PEAKS.items():
        if key in card_name:
            return value
    return None


def frames(cfg: dict, samples: int) -> int:
    """The conv stack's output length: floor((L - k) / s) + 1 per layer."""
    samples = int(samples)  # Python ints throughout: no fixed-width wrap
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        samples = (samples - k) // s + 1
    return samples


def conv_fe_flops(cfg: dict, samples: int) -> int:
    """Forward FLOPs of the conv feature extractor for one utterance."""
    total, length, cin = 0, int(samples), 1
    for cout, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"],
                          cfg["conv_stride"]):
        length = (length - k) // s + 1
        total += 2 * length * k * cin * cout
        cin = cout
    return total


def encoder_flops(cfg: dict, samples: int) -> int:
    """Forward FLOPs of the encoder for one utterance: the FE, the
    projection, the grouped positional conv and the layers (4 h x h
    projections, QK^T and AV, the FFN's two products)."""
    h = cfg["hidden_size"]
    t = frames(cfg, samples)
    proj = 2 * t * cfg["conv_dim"][-1] * h
    pos_conv = (2 * t * cfg["num_conv_pos_embeddings"]
                * (h // cfg["num_conv_pos_embedding_groups"]) * h)
    layer = 4 * 2 * t * h * h + 4 * t * t * h + 2 * 2 * t * h * cfg[
        "intermediate_size"]
    return (conv_fe_flops(cfg, samples) + proj + pos_conv
            + cfg["num_hidden_layers"] * layer)


def forward_flops(cfg: dict, samples: int) -> int:
    """One utterance's forward: the encoder and the family's heads (APTAI:
    the TV and phoneme heads and the 51-tap FIR; W2V2PR: the CTC head)."""
    t, h = frames(cfg, samples), cfg["hidden_size"]
    if cfg["family"] == "aptai":
        heads = 2 * t * h * (cfg["num_tvs"] + cfg["num_phonemes"])
        heads += 2 * t * 51 * cfg["num_tvs"]
    else:
        heads = 2 * t * h * cfg["vocab_size"]
    return encoder_flops(cfg, samples) + heads


def step_flops(cfg: dict, lengths: Iterable[int]) -> int:
    """Model FLOPs of one training step over utterances of ``lengths``
    samples: 3x the forward (the backward's two products per forward
    product). A frozen feature extractor has no backward: its forward
    counts once."""
    total = 0
    for n in lengths:
        n = int(n)
        fwd = forward_flops(cfg, n)
        if cfg.get("freeze_feature_encoder"):
            fe = conv_fe_flops(cfg, n)
            total += 3 * (fwd - fe) + fe
        else:
            total += 3 * fwd
    return total


def bound_s(flops: float, nbytes: float, card: Dict[str, float]
            ) -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_ops = flops / card["bf16_flops"]
    t_bytes = nbytes / card["bytes_per_s"]
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def flash_fwd_work(cfg: dict, frame_lengths: Iterable[int],
                   with_lse: bool = False) -> Tuple[int, int]:
    """(operations, bytes) the length-masked attention forward needs over
    every layer for utterances of ``frame_lengths`` valid frames: QK^T and
    PV over valid queries and keys; q, k, v read and the output written
    once in bf16 (and the float32 logsumexp under training)."""
    h = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // h
    frame_lengths = [int(n) for n in frame_lengths]
    flops = sum(4 * h * d * n * n for n in frame_lengths)
    rows = sum(frame_lengths)
    nbytes = 2 * h * d * 4 * rows + (4 * h * rows if with_lse else 0)
    n_layers = cfg["num_hidden_layers"]
    return n_layers * flops, n_layers * nbytes


def flash_bwd_work(cfg: dict, frame_lengths: Iterable[int]
                   ) -> Tuple[int, int]:
    """(operations, bytes) the attention backward needs over every layer:
    its five products (QK^T again, dO V^T, dV = P^T dO, dQ = dS K,
    dK = dS^T Q) over valid queries and keys; q, k, v, o, dO and the
    logsumexp read, dq, dk, dv written once."""
    h = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // h
    frame_lengths = [int(n) for n in frame_lengths]
    flops = sum(10 * h * d * n * n for n in frame_lengths)
    rows = sum(frame_lengths)
    nbytes = 2 * h * d * 8 * rows + 4 * h * rows
    n_layers = cfg["num_hidden_layers"]
    return n_layers * flops, n_layers * nbytes


def fused_conv_work(cfg: dict, sample_lengths: Iterable[int]
                    ) -> Tuple[int, int]:
    """(operations, bytes) the fused conv + LayerNorm + GELU layers need for
    utterances of ``sample_lengths`` samples: the layers with kernel 2 or
    3, stride 2 and a multiple of 128 input channels, each a
    (T_out, k C_in) x (k C_in, C_out) product over the valid frames; bf16
    input and output read and written once, the weight once per layer."""
    flops = nbytes = 0
    dims = list(zip((1,) + tuple(cfg["conv_dim"][:-1]), cfg["conv_dim"],
                    cfg["conv_kernel"], cfg["conv_stride"]))
    for i, (cin, cout, k, s) in enumerate(dims):
        fused = k in (2, 3) and s == 2 and cin % 128 == 0
        if fused:
            nbytes += 2 * k * cin * cout + 3 * 4 * cout
        for n in sample_lengths:
            length = int(n)
            for kk, ss in zip(cfg["conv_kernel"][:i], cfg["conv_stride"][:i]):
                length = (length - kk) // ss + 1
            t_out = (length - k) // s + 1
            if fused:
                flops += 2 * t_out * k * cin * cout
                nbytes += 2 * (length * cin + t_out * cout)
    return flops, nbytes
