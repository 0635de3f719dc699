"""Analytic FLOP count and MFU for the model family.

Counts the *model* FLOPs (multiply-accumulate = 2): useful matmul work at
the true sequence length, not the padded work the card executes.

  * conv feature extractor: per layer a (T_out, k·Cin)×(k·Cin, Cout)
    contraction;
  * feature projection; grouped positional conv 2·T·k·(C/G)·C;
  * per transformer layer: 4 h×h projections, QKᵀ + AV (4·T²·h), and the
    two FFN GEMMs;
  * the APTAI heads and the FIR, or the W2V2PR CTC head.

Elementwise work (LayerNorm, GELU, softmax) is left out. A training step
counts 3× the forward (the backward's two products per forward product),
whatever the remat policy: MFU counts the model's work, not recomputation,
which :func:`training_step_hfu_flops` adds for hardware utilisation. The
device peak comes from a table keyed by ``torch.cuda.get_device_name()``;
an unknown card gives no peak and so no MFU.
"""

from __future__ import annotations

from typing import Dict, Optional

from aptai_tpu_torch.models.configs import Wav2Vec2Config

# dense bf16 tensor-core peak, TFLOP/s, by a substring of the device name
# (NVIDIA H100 SXM data sheet; the SXM part reports "H100 80GB HBM3")
_PEAK_TFLOPS_BF16 = {
    "H100 80GB HBM3": 989.0,
}
# dense int8 tensor-core peak, TOP/s, by the same names (the same sheet)
_PEAK_TOPS_INT8 = {
    "H100 80GB HBM3": 1979.0,
}


def conv_fe_flops(cfg: Wav2Vec2Config, samples: int) -> int:
    """Forward FLOPs of the conv feature extractor for one utterance."""
    total = 0
    length = samples
    cin = 1
    for cout, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
        total += 2 * length * k * cin * cout
        cin = cout
    return total


def encoder_flops(cfg: Wav2Vec2Config, samples: int) -> Dict[str, int]:
    """Per-utterance forward FLOPs of the encoder, by term, plus
    ``"frames"`` and ``"total"``."""
    h = cfg.hidden_size
    t = int(cfg.feat_extract_output_lengths(samples))
    fe = conv_fe_flops(cfg, samples)
    proj = 2 * t * cfg.conv_dim[-1] * h
    pos_conv = (2 * t * cfg.num_conv_pos_embeddings
                * (h // cfg.num_conv_pos_embedding_groups) * h)
    attn_proj = 4 * 2 * t * h * h
    attn_scores = 4 * t * t * h          # QK^T + AV, all heads combined
    ffn = 2 * 2 * t * h * cfg.intermediate_size
    layers = cfg.num_hidden_layers * (attn_proj + attn_scores + ffn)
    out = {
        "frames": t,
        "conv_fe": fe,
        "feature_projection": proj,
        "pos_conv": pos_conv,
        "attention_projections": cfg.num_hidden_layers * attn_proj,
        "attention_scores": cfg.num_hidden_layers * attn_scores,
        "ffn": cfg.num_hidden_layers * ffn,
    }
    out["total"] = fe + proj + pos_conv + layers
    return out


def aptai_forward_flops(cfg: Wav2Vec2Config, samples: int,
                        num_phonemes: int = 46, num_tvs: int = 9) -> int:
    """APTAI predict: encoder + TV head + phoneme head + FIR."""
    enc = encoder_flops(cfg, samples)
    t, h = enc["frames"], cfg.hidden_size
    heads = 2 * t * h * num_tvs + 2 * t * h * num_phonemes
    fir = 2 * t * 51 * num_tvs
    return enc["total"] + heads + fir


def pr_forward_flops(cfg: Wav2Vec2Config, samples: int,
                     vocab_size: Optional[int] = None) -> int:
    """W2V2PR forward: encoder + the CTC head."""
    enc = encoder_flops(cfg, samples)
    v = cfg.vocab_size if vocab_size is None else vocab_size
    return enc["total"] + 2 * enc["frames"] * cfg.hidden_size * v


def training_step_flops(forward_flops: int) -> int:
    """Model FLOPs of one forward + backward step: 3× the forward, for any
    remat policy (recomputation is not model work)."""
    return 3 * forward_flops


def training_step_hfu_flops(forward_flops: int,
                            remat_policy: str = "none") -> int:
    """Hardware FLOPs of one step: 4× the forward under ``"full"`` remat
    (the backward replays the forward), 3× otherwise."""
    return (4 if remat_policy == "full" else 3) * forward_flops


def device_peak_tflops(name: Optional[str] = None) -> Optional[float]:
    """Dense bf16 peak TFLOP/s of a card by name (None = CUDA device 0);
    None for a card not in the table."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name(0)
    for key, peak in _PEAK_TFLOPS_BF16.items():
        if key in name:
            return peak
    return None


def device_peak_int8_tops(device=None) -> Optional[float]:
    """Dense int8 peak TOP/s of a card (None = CUDA device 0; a device or
    index, or the card's name as a string); None for a card not in the
    table, so callers omit the bound instead of guessing a peak. The
    longest key found in the name wins."""
    if isinstance(device, str) and not device.startswith("cuda"):
        name = device
    else:
        import torch

        name = torch.cuda.get_device_name(0 if device is None else device)
    best = None
    for key, peak in _PEAK_TOPS_INT8.items():
        if key in name and (best is None or len(key) > len(best[0])):
            best = (key, peak)
    return best[1] if best else None


def mfu(total_flops: int, seconds: float,
        peak_tflops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None if the peak is unknown."""
    if peak_tflops is None or seconds <= 0:
        return None
    return (total_flops / seconds) / (peak_tflops * 1e12)
