"""A plain float32 wav2vec2 encoder with the APTAI and W2V2PR heads.

Written from the published model (``facebook/wav2vec2-large-robust``: a
layer-norm conv feature extractor, a weight-normed grouped positional conv,
pre-norm transformer layers, a final LayerNorm) and the APTAI heads (a TV
head of Linear(tanh h) smoothed by a 51-tap windowed-sinc low-pass over the
whole padded frame axis, a phoneme head of Linear(leaky_relu h)); the
W2V2PR head is one Linear. Plain ``torch`` operations in float32 with TF32
off, every GELU exact (erf), as the published model computes it. It
imports nothing of the program.

``precision="fp8"`` rounds both operands of every product (convs, linears,
the attention's two products) through float8 e4m3 with one scale a tensor,
and the gradients entering the linears' and attention's backward products
through e5m2: the control, computed a precision below the configuration's
bf16, as fp8 training runs on Hopper.

Parameters are a dict of float32 tensors under the HF ``Wav2Vec2Model``
names, prefixed ``wav2vec2.``; the heads are ``tv_linear``, ``phn_linear``
(APTAI) or ``pr_head`` (W2V2PR).

Training draws (dropout masks, SpecAugment's time mask) come in a
:class:`Draws`, which :mod:`port_bench.reference.draws` fills in the order
the configuration's forward draws them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# the largest value of each float8 format: e4m3 for the forward's operands,
# e5m2 for the gradients, as fp8 training recipes on Hopper use them
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8_round(x: torch.Tensor,
              dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded through float8 ``dtype``, scaled so its largest
    magnitude maps to the format's largest value."""
    scale = FP8_MAX[dtype] / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded through float8 e4m3, and the
    backward's two products likewise, the incoming gradient through e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, torch.float8_e5m2)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def _fp8_straight_through(x):
    """``x`` rounded through float8 forward, its gradient passed as is."""
    return x + (fp8_round(x) - x).detach()


class Ops:
    """The products, in float32 or through fp8 (the linears' and the
    attention's forward and backward products; the convolutions' inputs
    and weights in the forward)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def linear(self, x, w, b=None):
        if self.fp8:
            y = _Fp8Product.apply(x.reshape(-1, x.shape[-1]),
                                  w.t()).view(*x.shape[:-1], w.shape[0])
        else:
            y = torch.matmul(x, w.t())
        return y if b is None else y + b

    def conv1d(self, x, w, b, **kw):
        if self.fp8:
            x, w = _fp8_straight_through(x), _fp8_straight_through(w)
        return F.conv1d(x, w, b, **kw)

    def matmul(self, a, b):
        return _Fp8Product.apply(a, b) if self.fp8 else torch.matmul(a, b)


def layer_norm(x, p, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), p[prefix + ".weight"],
                        p[prefix + ".bias"], eps)


def lowpass_taps(cutoff_hz: float, rate_hz: float,
                 transition: float = 0.08) -> np.ndarray:
    """Windowed-sinc low-pass taps: cutoff / rate, ceil(4 / transition)
    taps made odd, a Hann window, normalised to sum 1."""
    fc = cutoff_hz / rate_hz
    n_taps = int(math.ceil(4 / transition))
    n_taps += 1 - n_taps % 2
    n = np.arange(n_taps)
    h = np.sinc(2 * fc * (n - (n_taps - 1) / 2))
    h = h * 0.5 * (1 - np.cos(2 * np.pi * n / (n_taps - 1)))
    return h / h.sum()


def frame_count(cfg, samples):
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        samples = (samples - k) // s + 1
    return samples


class Draws:
    """One training step's random draws for a block of rows: dropout keep
    masks by site (each a bool tensor, the whole batch's) and the
    SpecAugment time mask (B, T); ``rows`` selects the block."""

    def __init__(self, masks: Dict[str, torch.Tensor],
                 time_mask: Optional[torch.Tensor], rates: Dict[str, float]):
        self.masks, self.time_mask, self.rates = masks, time_mask, rates
        self.rows = slice(None)

    def block(self, rows: slice) -> "Draws":
        d = Draws(self.masks, self.time_mask, self.rates)
        d.rows = rows
        return d

    def drop(self, x, site: str, rate_key: str):
        keep = self.masks[site][self.rows]
        return x * keep / (1.0 - self.rates[rate_key])


def _gelu(x):
    return F.gelu(x)


def encode(p, cfg, audio, lengths, ops: Ops, draws: Optional[Draws] = None):
    """The encoder's output (B, T, hidden) and the valid frame counts.
    ``audio`` (B, L) float32 padded with zeros; ``lengths`` (B,) samples.
    With ``draws`` the training forward (dropout, SpecAugment)."""
    eps = cfg["layer_norm_eps"]
    h = audio[:, None, :]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        pre = f"wav2vec2.feature_extractor.conv_layers.{i}"
        h = ops.conv1d(h, p[pre + ".conv.weight"], p.get(pre + ".conv.bias"),
                       stride=s)
        h = layer_norm(h.transpose(1, 2), p, pre + ".layer_norm",
                       eps).transpose(1, 2)
        h = _gelu(h)
    feats = h.transpose(1, 2)
    t = feats.shape[1]
    flen = frame_count(cfg, lengths.long())
    valid = torch.arange(t, device=audio.device)[None, :] < flen[:, None]
    h = layer_norm(feats, p, "wav2vec2.feature_projection.layer_norm", eps)
    h = ops.linear(h, p["wav2vec2.feature_projection.projection.weight"],
                   p["wav2vec2.feature_projection.projection.bias"])
    if draws is not None:
        h = draws.drop(h, "feat_proj", "feat_proj_dropout")
        if draws.time_mask is not None:
            tm = draws.time_mask[draws.rows] & valid
            h = torch.where(tm[:, :, None], p["wav2vec2.masked_spec_embed"], h)
    h = h * valid[:, :, None]
    # the positional conv: weight = g v / |v|, the norm over (out, in) for
    # each tap; 'same' padding, the trailing frame of an even kernel dropped
    pre = "wav2vec2.encoder.pos_conv_embed.conv"
    v = p[pre + ".weight_v"]
    w = p[pre + ".weight_g"] * v / torch.sqrt(
        (v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
    kpos = v.shape[-1]
    pos = ops.conv1d(h.transpose(1, 2), w, p[pre + ".bias"],
                     padding=kpos // 2,
                     groups=cfg["num_conv_pos_embedding_groups"])
    h = h + _gelu(pos[:, :, :t].transpose(1, 2))
    if draws is not None:
        h = draws.drop(h, "encoder", "hidden_dropout")
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    key_ok = valid[:, None, None, :]
    b = h.shape[0]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"wav2vec2.encoder.layers.{i}"
        a = layer_norm(h, p, pre + ".layer_norm", eps)

        def proj(name, x):
            return ops.linear(x, p[f"{pre}.attention.{name}.weight"],
                              p[f"{pre}.attention.{name}.bias"])

        q, kk, vv = (proj(n, a).view(b, t, heads, d).transpose(1, 2)
                     for n in ("q_proj", "k_proj", "v_proj"))
        scores = ops.matmul(q, kk.transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~key_ok, float("-inf"))
        ctx = ops.matmul(torch.softmax(scores, dim=-1), vv)
        out = proj("out_proj", ctx.transpose(1, 2).reshape(b, t, -1))
        if draws is not None:
            out = draws.drop(out, f"attn{i}", "attention_dropout")
        h = h + out
        f = layer_norm(h, p, pre + ".final_layer_norm", eps)
        f = _gelu(ops.linear(f, p[pre + ".feed_forward.intermediate_dense."
                                    "weight"],
                             p[pre + ".feed_forward.intermediate_dense.bias"]))
        if draws is not None:
            f = draws.drop(f, f"act{i}", "activation_dropout")
        f = ops.linear(f, p[pre + ".feed_forward.output_dense.weight"],
                       p[pre + ".feed_forward.output_dense.bias"])
        if draws is not None:
            f = draws.drop(f, f"ffn{i}", "hidden_dropout")
        h = h + f
    h = layer_norm(h, p, "wav2vec2.encoder.layer_norm", eps)
    return h, flen


def aptai_heads(p, cfg, hidden, ops: Ops, draws: Optional[Draws] = None):
    """(TVs (B, T, 9) smoothed over the whole padded axis, phoneme logits
    (B, T, num_phonemes))."""
    ht, hp = hidden, hidden
    if draws is not None:
        ht = draws.drop(hidden, "tv_head", "tv_drop")
        hp = draws.drop(hidden, "phn_head", "phn_drop")
    tv = ops.linear(torch.tanh(ht), p["tv_linear.weight"], p["tv_linear.bias"])
    taps = torch.tensor(lowpass_taps(cfg["lowpass_cutoff_hz"],
                                     cfg["frame_rate_hz"]),
                        dtype=torch.float64, device=hidden.device)
    n = taps.shape[0]
    # a depthwise 'same' correlation with zeros past both ends, in float64
    tv = F.conv1d(F.pad(tv.double().transpose(1, 2), (n // 2, n // 2)),
                  taps.flip(0).expand(tv.shape[-1], 1, n),
                  groups=tv.shape[-1]).transpose(1, 2).float()
    logits = ops.linear(F.leaky_relu(hp, 0.01), p["phn_linear.weight"],
                        p["phn_linear.bias"])
    return tv, logits


def pr_head(p, hidden, ops: Ops):
    return ops.linear(hidden, p["pr_head.weight"], p["pr_head.bias"])


@torch.no_grad()
def predict(p, cfg, audio, lengths, precision: str = "f32",
            block: int = 8):
    """APTAI's served outputs, computed ``block`` rows at a time:
    ``tvs_pred`` (B, T, 9), ``phn_fc_logits`` (B, T, V) and
    ``frame_lengths``."""
    ops = Ops(precision)
    tvs, logits, flens = [], [], []
    for lo in range(0, audio.shape[0], block):
        h, flen = encode(p, cfg, audio[lo:lo + block],
                         lengths[lo:lo + block], ops)
        tv, lg = aptai_heads(p, cfg, h, ops)
        tvs.append(tv)
        logits.append(lg)
        flens.append(flen)
    return {"tvs_pred": torch.cat(tvs), "phn_fc_logits": torch.cat(logits),
            "frame_lengths": torch.cat(flens)}
