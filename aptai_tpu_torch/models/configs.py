"""Model configuration.

``Wav2Vec2Config`` carries every field of the JAX package's config with the
same defaults (``facebook/wav2vec2-large-robust``: 24 pre-norm layers,
hidden 1024, 16 heads, FFN 4096, layer-norm conv feature extractor), so a
config serialised by either package means the same model.

Fields whose behaviour this package does not implement yet raise
``NotImplementedError`` when set to a non-default value: nothing silently
computes something else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# dynamic W8A8 int8 inference GEMMs (ops/quant.py): none, the FFN's two
# Linears, or those and the attention's four projections
QUANT_MODES = ("none", "w8a8_ffn", "w8a8")
# the JAX package's attention layouts: head projections straight to
# (B, H, T, D), or (B, T, C) projections split into heads. This package
# computes both alike; they differ only in what "w8a8" quantizes
ATTENTION_LAYOUTS = ("bhtd", "bthd")


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    # transformer encoder
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    # the encoder's LayerNorm after the layer stack (True) or after the
    # positional conv, before it (False); the layers are pre-norm either way
    do_stable_layer_norm: bool = True

    # conv feature extractor (~49 frames/s)
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)

    # convolutional relative positional embedding
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16

    # dropout / regularization (training only)
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    final_dropout: float = 0.1
    layerdrop: float = 0.0

    # SpecAugment-style masking (training only)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0

    # CTC head
    vocab_size: int = 46
    blank_id: int = 0
    ctc_loss_reduction: str = "mean"
    ctc_zero_infinity: bool = True

    # numerics
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # "auto": tanh-approximate GELU in bfloat16, exact erf in float32
    gelu: str = "auto"
    # training only: "none" (save every activation), "full" (per-layer
    # torch.utils.checkpoint) or "dots" (per layer, the dense products'
    # outputs saved and the rest recomputed)
    remat_policy: str = "none"
    attention_layout: str = "bhtd"
    fused_qkv: bool = False
    quant: str = "none"  # "none" | "w8a8_ffn" | "w8a8"
    activation_partition: Optional[Tuple[Optional[str], Optional[str],
                                         Optional[str]]] = None
    # the mid-stack feature-extractor layers (kernel 2 or 3, stride 2,
    # C_in % 128 == 0) as one fused conv + LayerNorm + exact GELU op
    # (ops/fused_conv.py), channels-last after layer 0; it has no backward
    fused_feature_extractor: bool = False

    def __post_init__(self):
        if self.activation_partition is not None:
            raise NotImplementedError(
                "activation_partition is not implemented in aptai_tpu_torch "
                "yet (ROADMAP Queue 1 item 8e-ii); leave it None")
        if self.attention_layout not in ATTENTION_LAYOUTS:
            # the JAX package runs any other string as "bthd"
            raise ValueError(f"attention_layout must be one of "
                             f"{list(ATTENTION_LAYOUTS)}, got "
                             f"{self.attention_layout!r}")
        if self.quant not in QUANT_MODES:
            # the JAX package serves an unknown string as "none"
            raise ValueError(f"quant must be one of {list(QUANT_MODES)}, "
                             f"got {self.quant!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")
        if self.remat_policy not in ("none", "full", "dots"):
            raise ValueError(f"remat_policy must be 'none', 'full' or "
                             f"'dots', got {self.remat_policy!r}")
        if self.gelu not in ("auto", "exact", "tanh"):
            raise ValueError(f"gelu must be 'auto', 'exact' or 'tanh', "
                             f"got {self.gelu!r}")

    def with_ten_ms(self) -> "Wav2Vec2Config":
        """10 ms frame-rate variant: final conv stride 2 → 1."""
        return dataclasses.replace(
            self, conv_stride=self.conv_stride[:-1] + (1,)
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def feat_extract_output_lengths(self, input_lengths):
        """Conv-stack output length: floor((L - k) / s) + 1 per layer.
        Works on Python ints, numpy arrays and torch tensors alike."""
        lengths = input_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - k) // s + 1
        return lengths


def tiny_config(**overrides) -> Wav2Vec2Config:
    """A small config for tests: same topology, tiny dims."""
    base = dict(
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        conv_dim=(16,) * 3,
        conv_kernel=(10, 3, 3),
        conv_stride=(5, 2, 2),
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        vocab_size=11,
    )
    base.update(overrides)
    return Wav2Vec2Config(**base)
