"""wav2vec2-style acoustic encoder, inference path.

  raw wave (B, L)
    → conv feature extractor: per layer Conv1d → channel LayerNorm → GELU
      (layer 0: k10 s5 from 1 channel)
    → feature projection: LayerNorm → Linear(hidden)
    → pad frames zeroed
    → + weight-normed grouped positional conv (k, groups; trailing frame
      dropped for even k) → GELU
    → pre-norm transformer layers (length-masked attention through
      ``ops.attention``, GELU FFN)
    → final LayerNorm

Parameter names are those of HF ``Wav2Vec2Model``, so an HF state_dict or
the JAX package's export (``aptai_tpu.models.hf_convert``) loads as is.

Dtype policy, set once in :func:`_cast_matmul_weights`: with
``cfg.dtype == "bfloat16"`` the Linear and Conv1d weights (and biases) are
bf16 from construction on, and activations flow in bf16; LayerNorm
parameters and the positional conv's weight-norm parameters stay float32,
LayerNorm statistics are taken in float32, and the weight-normed kernel is
composed in float32 before its cast. SpecAugment, dropout and the
training-time options belong to the training path and are not here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.ops.attention import multi_head_attention_bhtd


def _compute_dtype(cfg: Wav2Vec2Config) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _gelu(x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    """GELU per ``cfg.gelu``: "auto" is tanh-approximate in bfloat16 and
    exact erf in float32."""
    mode = cfg.gelu
    if mode == "auto":
        mode = "tanh" if cfg.dtype == "bfloat16" else "exact"
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with float32 statistics and parameters;
    the result returns to the activation dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


class ConvLayerBlock(nn.Module):
    """One feature-extractor layer: valid strided Conv1d → channel
    LayerNorm (``feat_extract_norm == "layer"``) → GELU, on (B, C, L)."""

    def __init__(self, cfg: Wav2Vec2Config, c_in: int, c_out: int,
                 kernel: int, stride: int):
        super().__init__()
        self.cfg = cfg
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride,
                              bias=cfg.conv_bias)
        self.layer_norm = (nn.LayerNorm(c_out, eps=cfg.layer_norm_eps)
                           if cfg.feat_extract_norm == "layer" else None)

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = _layer_norm(self.layer_norm, x.transpose(1, 2)).transpose(1, 2)
        return _gelu(x, self.cfg)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        c_in = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayerBlock(cfg, ci, co, k, s) for ci, co, k, s in zip(
                c_in, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride))

    def forward(self, x):  # (B, L) -> (B, T_frames, conv_dim[-1])
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(_layer_norm(self.layer_norm, x))


class WeightNormConv1d(nn.Module):
    """Grouped 'same' Conv1d whose kernel is ``g · v / sqrt(Σv² + 1e-12)``
    with the sum over (out, in/groups) for each tap (HF legacy
    ``weight_g``/``weight_v`` names)."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight_v, std=4.0 / np.sqrt(kernel * channels))

    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
        return self.weight_g.float() * v / norm

    def forward(self, x):  # (B, C, T)
        k = self.weight_v.shape[-1]
        return F.conv1d(x, self.weight().to(x.dtype), self.bias.to(x.dtype),
                        padding=k // 2, groups=self.groups)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.conv = WeightNormConv1d(cfg.hidden_size,
                                     cfg.num_conv_pos_embeddings,
                                     cfg.num_conv_pos_embedding_groups)

    def forward(self, x):  # (B, T, C) -> (B, T, C)
        t = x.shape[1]
        h = self.conv(x.transpose(1, 2))
        # HF SamePadLayer: an even kernel gives one frame too many
        h = h[:, :, :t].transpose(1, 2)
        return _gelu(h, self.cfg)


class SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.heads = cfg.num_attention_heads
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, lengths):  # (B, T, C)
        b, t, c = x.shape
        d = c // self.heads

        def to_heads(proj):  # a (B, H, T, D) view, no copy
            return proj(x).view(b, t, self.heads, d).transpose(1, 2)

        ctx = multi_head_attention_bhtd(to_heads(self.q_proj),
                                        to_heads(self.k_proj),
                                        to_heads(self.v_proj), lengths)
        # free when the kernel wrote its (B, T, H, D) buffer
        return self.out_proj(ctx.transpose(1, 2).reshape(b, t, c))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(_gelu(self.intermediate_dense(x), self.cfg))


class EncoderLayer(nn.Module):
    """Pre-norm ("stable layer norm") transformer layer."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = SelfAttention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)

    def forward(self, x, lengths):
        x = x + self.attention(_layer_norm(self.layer_norm, x), lengths)
        return x + self.feed_forward(_layer_norm(self.final_layer_norm, x))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, frame_lengths):
        h = h + self.pos_conv_embed(h)
        for layer in self.layers:
            h = layer(h, frame_lengths)
        return _layer_norm(self.layer_norm, h)


def _cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> None:
    """The dtype policy: Linear and Conv1d parameters in the compute dtype;
    everything else (LayerNorm, weight-norm g/v, embeddings) float32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            m.to(dtype)


class Wav2Vec2Model(nn.Module):
    """Backbone: feature extractor → projection → transformer stack.

    ``forward(input_values, input_lengths)`` returns ``(hidden_states,
    frame_lengths, extract_features)``: the final-LayerNorm output
    (B, T, hidden), the int32 valid frame count per item, and the conv
    features (B, T, conv_dim[-1]).
    """

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        if cfg.apply_spec_augment:
            # the training path's SpecAugment embedding; carried so that
            # checkpoints load and save with every HF key
            self.masked_spec_embed = nn.Parameter(
                torch.rand(cfg.hidden_size))
        _cast_matmul_weights(self, _compute_dtype(cfg))

    def forward(self, input_values: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, l = input_values.shape
        if input_lengths is None:
            input_lengths = torch.full((b,), l, dtype=torch.int32,
                                       device=input_values.device)
        feats = self.feature_extractor(
            input_values.to(_compute_dtype(cfg)))
        frame_lengths = cfg.feat_extract_output_lengths(
            input_lengths.to(torch.int32))
        t = feats.shape[1]
        frame_mask = (torch.arange(t, device=feats.device)[None, :]
                      < frame_lengths[:, None])
        h = self.feature_projection(feats)
        # pad frames are zeroed before the positional conv
        h = h * frame_mask[:, :, None].to(h.dtype)
        return self.encoder(h, frame_lengths), frame_lengths, feats


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in the JAX package's
    distributions: LeCun-normal Linear/Conv1d weights (std 1/√fan_in),
    zero biases, unit LayerNorm scales, weight-norm ``v`` normal with std
    4/√(k·C) and ``g`` ones. Draws in float32 on the generator's device,
    then casts into each parameter."""
    dev = generator.device

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev) * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, 1.0 / np.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WeightNormConv1d):
            k, c = m.weight_v.shape[-1], m.weight_v.shape[0]
            normal_(m.weight_v, 4.0 / np.sqrt(k * c))
            m.weight_g.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Wav2Vec2Model) and hasattr(m, "masked_spec_embed"):
            m.masked_spec_embed.copy_(torch.rand(
                m.masked_spec_embed.shape, generator=generator, device=dev))
