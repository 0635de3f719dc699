"""wav2vec2-style acoustic encoder, inference and training paths.

  raw wave (B, L)
    → conv feature extractor: per layer Conv1d → channel LayerNorm → GELU
      (layer 0: k10 s5 from 1 channel); under ``torch.no_grad()`` when the
      feature encoder is frozen. With ``cfg.fused_feature_extractor`` it runs
      channels-last after layer 0, and each layer that
      :func:`_fused_fe_applicable` admits is one fused conv + LayerNorm +
      exact GELU op (``ops.fused_conv``: the Hopper kernel on the card), which
      has no backward
    → feature projection: LayerNorm → Linear(hidden) → dropout
    → [train() only] SpecAugment: sampled time spans replaced by the learned
      mask embedding, sampled channel spans zeroed (an external
      ``time_mask`` replaces the time sampling in either mode)
    → pad frames zeroed
    → + weight-normed grouped positional conv (k, groups; trailing frame
      dropped for even k) → GELU, then dropout
    → [``do_stable_layer_norm=False``] LayerNorm, whose output is float32
    → pre-norm transformer layers (q, k and v from three Linears or, with
      ``cfg.fused_qkv``, as views of one; length-masked attention through
      ``ops.attention``, dropout on the out-projection output; GELU FFN with
      dropout after the GELU and after the FFN), each under
      ``torch.utils.checkpoint`` with ``remat_policy="full"`` (the layer's
      input saved, the rest recomputed) or ``"dots"`` (the dense products'
      outputs saved, the rest recomputed, attention included)
    → [``do_stable_layer_norm=True``, the default] final LayerNorm

Dropouts sit where the JAX package puts them, not where HF does: attention
dropout acts on the out-projection's output, so the attention kernels need
none. Dropout and SpecAugment act only in ``train()`` mode.

Parameter names are those of HF ``Wav2Vec2Model``, so an HF state_dict or
the JAX package's export (``aptai_tpu.models.hf_convert``) loads as is.

Dtype policy (the JAX package's): every parameter is float32, and with
``cfg.dtype == "bfloat16"`` the Linear and Conv1d ops cast their weights
and biases to the activation dtype (bf16) inside the op, so activations
flow in bf16 while Adam updates float32 masters. LayerNorm statistics are
taken in float32 with float32 parameters, and the weight-normed kernel is
composed in float32 before its cast. With ``do_stable_layer_norm=False``
the LayerNorm after the positional conv returns float32, as the JAX
package's (which has no ``dtype``) does, so the residual stream and the
encoder's output are float32 while the layers' sublayers still compute in
the compute dtype. For serving,
:func:`cast_matmul_weights` turns a copy's Linear and Conv1d parameters to
bf16 once, and the in-op casts become no-ops.

``cfg.quant`` (inference only) runs the FFN's two Linears (``"w8a8_ffn"``),
or those and the attention's four projections (``"w8a8"``, where the JAX
package quantizes them: with ``attention_layout="bhtd"`` and without
``fused_qkv``), as :class:`QuantLinear`: dynamic W8A8 int8 products
(``ops/quant.py``) with the same parameters, which a serving copy keeps in
float32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.ops.attention import multi_head_attention_bhtd
from aptai_tpu_torch.ops.fused_conv import fused_conv_ln_gelu, kernel_weight
from aptai_tpu_torch.ops.quant import (quantize_rows, quantize_weight,
                                       w8a8_linear)
from aptai_tpu_torch.parallel.global_batch import global_rows
from aptai_tpu_torch.parallel.tensor import (copy_to_model, gather_time,
                                             gather_time_replicated,
                                             reduce_from_model,
                                             reduce_scatter_time,
                                             scatter_time)


def compute_dtype(cfg: Wav2Vec2Config) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _gelu(x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    """GELU per ``cfg.gelu``: "auto" is tanh-approximate in bfloat16 and
    exact erf in float32."""
    mode = cfg.gelu
    if mode == "auto":
        mode = "tanh" if cfg.dtype == "bfloat16" else "exact"
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None,
                axis=None) -> torch.Tensor:
    """LayerNorm over the last dim with float32 statistics and parameters;
    the result in ``dtype`` (None: the activation dtype). ``axis``: the
    model axis ``x`` is a time shard of (sequence parallelism), over which
    the parameters' gradients are summed."""
    return F.layer_norm(x.float(), ln.normalized_shape,
                        copy_to_model(ln.weight, axis),
                        copy_to_model(ln.bias, axis),
                        ln.eps).to(dtype or x.dtype)


def _dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    return F.dropout(x, rate, training=True) if training and rate else x


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype: the (float32) weight
    and bias are cast to it inside the op."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QuantLinear(Linear):
    """:class:`Linear` whose product runs in dynamic W8A8 int8
    (``ops/quant.py``): the JAX package's ``QuantDense`` (FFN,
    ``fold_scales=False``) or its quantized ``HeadProjBHTD`` /
    ``OutProjBHTD`` (attention, ``fold_scales=True``). The parameters are
    :class:`Linear`'s, so state dicts are those of the exact model; they
    stay float32 in a serving copy (:func:`cast_matmul_weights`), and the
    weight codes are made from them, as the JAX package makes them from
    its float32 kernels. Inference only: a forward that needs a gradient
    raises."""

    def __init__(self, in_features: int, out_features: int,
                 fold_scales: bool):
        super().__init__(in_features, out_features)
        self.fold_scales = fold_scales
        self._codes = None  # (key, QuantizedWeight)

    def forward(self, x, x_codes=None):
        """``x_codes``: :func:`quantize_rows` of ``x``, where the caller
        shares one quantization among the layers that read ``x``."""
        self._refuse_gradient(x)
        xq = quantize_rows(x) if x_codes is None else x_codes
        y = w8a8_linear(xq, self.weight_codes(), self.fold_scales, x.dtype)
        return y + self.bias.to(x.dtype)

    def _refuse_gradient(self, x):
        if torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in self.parameters())):
            raise NotImplementedError(
                "quant (W8A8) is inference only: run under torch.no_grad() "
                "or torch.inference_mode(), or train with quant='none'")

    def row_parallel_product(self, x, axis):
        """The product without its bias, this layer holding its input
        features' slice on the model ``axis`` and ``x`` the matching slice
        of the input: the activation's row maxima and the weight's channel
        maxima are taken over the axis, so the codes are the unsharded
        layer's, and the int32 products are summed over it (exact;
        reduce-scattered over time under sequence parallelism) before the
        dequantization, so the output is the unsharded layer's too."""
        self._refuse_gradient(x)

        def reduce(y, scale):
            if axis.sequence:
                return (reduce_scatter_time(y, axis),
                        scale.chunk(axis.size, 1)[axis.rank])
            return reduce_from_model(y, axis), scale

        return w8a8_linear(quantize_rows(x, axis), self.weight_codes(axis),
                           self.fold_scales, x.dtype, reduce=reduce)

    def weight_codes(self, axis=None):
        """The weight's :func:`quantize_weight` (its channel maxima over the
        model ``axis`` for a row-parallel layer): made once and reused
        until the weight changes (in place, or by a move or a cast). Under
        ``torch.export`` (whose parameters have no storage to key on) it is
        made in the traced program."""
        w = self.weight
        if torch.compiler.is_compiling():
            return quantize_weight(w.detach(), axis)
        key = (w.device, w.dtype, w.data_ptr(), w._version, axis is None)
        if self._codes is None or self._codes[0] != key:
            with torch.no_grad():
                self._codes = (key, quantize_weight(w.detach(), axis))
        return self._codes[1]


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in the input's dtype, like :class:`Linear`."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _fused_fe_applicable(cfg: Wav2Vec2Config, kernel: int, stride: int,
                         c_in: int) -> bool:
    """Whether a feature-extractor layer runs as the fused conv + LayerNorm
    + GELU op: the homogeneous mid-stack layers (wide channels, kernel 2 or
    3, stride 2) under ``cfg.fused_feature_extractor``. Not layer 0 (k10
    s5 from 1 channel), nor the stride-1 last layer of ``with_ten_ms()``."""
    return (cfg.fused_feature_extractor
            and cfg.feat_extract_norm == "layer"
            and kernel in (2, 3)
            and stride == 2
            and c_in % 128 == 0)


class ConvLayerBlock(nn.Module):
    """One feature-extractor layer: valid strided Conv1d → channel
    LayerNorm (``feat_extract_norm == "layer"``) → GELU, on (B, C, L)
    (``forward``) or channels-last (B, L, C) (``forward_channels_last``).
    A layer that :func:`_fused_fe_applicable` admits runs channels-last as
    the fused op, whose numerics are its own: exact GELU whatever
    ``cfg.gelu`` says, LayerNorm statistics and parameters in float32, the
    bias rounded to the compute dtype and added in float32."""

    def __init__(self, cfg: Wav2Vec2Config, c_in: int, c_out: int,
                 kernel: int, stride: int):
        super().__init__()
        self.cfg = cfg
        self.conv = Conv1d(c_in, c_out, kernel, stride=stride,
                           bias=cfg.conv_bias)
        self.layer_norm = (nn.LayerNorm(c_out, eps=cfg.layer_norm_eps)
                           if cfg.feat_extract_norm == "layer" else None)
        self.fused = _fused_fe_applicable(cfg, kernel, stride, c_in)
        self._fused_weights = None  # (key, kernel-layout weight, bias)

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = _layer_norm(self.layer_norm, x.transpose(1, 2)).transpose(1, 2)
        return _gelu(x, self.cfg)

    def forward_channels_last(self, x):  # (B, L, C_in) -> (B, T, C_out)
        if self.fused:
            return self._forward_fused(x)
        x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.layer_norm is not None:
            x = _layer_norm(self.layer_norm, x)
        return _gelu(x, self.cfg)

    def _forward_fused(self, x):
        # the op refuses an input that needs a gradient; its weights here
        # are a detached copy, so the parameters are checked first
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.parameters()):
            raise NotImplementedError(
                "fused_feature_extractor has no backward: freeze the feature "
                "encoder (or run under torch.no_grad()) to use it, or turn it "
                "off to train the feature encoder")
        w, b = self._kernel_weights(x.dtype)
        ln = self.layer_norm
        return fused_conv_ln_gelu(x.contiguous(), w, b, ln.weight.float(),
                                  ln.bias.float(), self.conv.stride[0],
                                  ln.eps)

    def _kernel_weights(self, dtype: torch.dtype):
        """The conv weight in the kernel's (C_out, k, C_in) layout and the
        bias, both in ``dtype``: made once and reused until the parameters
        change (in place, or by a move or a cast). Under ``torch.export``
        (whose parameters have no storage to key on) they are made in the
        traced program."""
        w, b = self.conv.weight, self.conv.bias
        if torch.compiler.is_compiling():
            return (kernel_weight(w.detach().to(dtype)),
                    None if b is None else b.detach().to(dtype).contiguous())
        key = (dtype, w.device, w.data_ptr(), w._version,
               None if b is None else (b.data_ptr(), b._version))
        if self._fused_weights is None or self._fused_weights[0] != key:
            with torch.no_grad():
                self._fused_weights = (
                    key, kernel_weight(w.detach().to(dtype)),
                    None if b is None else b.detach().to(dtype).contiguous())
        return self._fused_weights[1:]


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.channels_last = cfg.fused_feature_extractor
        c_in = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayerBlock(cfg, ci, co, k, s) for ci, co, k, s in zip(
                c_in, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride))

    def forward(self, x):  # (B, L) -> (B, T_frames, conv_dim[-1])
        if self.channels_last:
            # layer 0 transposes its output once; every later layer reads
            # and writes (B, T, C)
            h = x[:, :, None]
            for layer in self.conv_layers:
                h = layer.forward_channels_last(h)
            return h
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        h = self.projection(_layer_norm(self.layer_norm, x))
        return _dropout(h, self.cfg.feat_proj_dropout, self.training)


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


def _column_input(x: torch.Tensor, axis) -> torch.Tensor:
    """The input of a column-parallel product on the model ``axis``: ``x``
    itself (its gradient summed over the axis), or under sequence
    parallelism the whole sequence gathered from the time shards."""
    if axis is None:
        return x
    return gather_time(x, axis) if axis.sequence else copy_to_model(x, axis)


def _row_parallel(linear: Linear, x: torch.Tensor, axis) -> torch.Tensor:
    """``linear`` on ``x``; on the model ``axis`` a row-parallel product
    (``linear`` holds its slice of the input features, ``x`` the matching
    slice of the input): the partial products summed over the axis (under
    sequence parallelism reduce-scattered to this process's time shard),
    then the bias, added once."""
    if axis is None:
        return linear(x)
    if isinstance(linear, QuantLinear):
        y = linear.row_parallel_product(x, axis)
    else:
        y = F.linear(x, linear.weight.to(x.dtype))
        y = (reduce_scatter_time(y, axis) if axis.sequence
             else reduce_from_model(y, axis))
    bias = linear.bias.to(y.dtype)
    # on a time shard each process adds it to its own frames
    return y + (copy_to_model(bias, axis) if axis.sequence else bias)


class SelfAttention(nn.Module):
    """Multi-head self-attention. On the model axis (``model_axis``, set by
    ``parallel.mesh.split_model_axis``) each process holds H/n heads: its
    rows of q, k and v (column-parallel; the fused q/k/v product stays
    whole, and each process reads its heads' views of it) and its columns
    of the output projection (row-parallel)."""

    model_axis = None

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        # "w8a8_ffn" leaves the projections exact, and so does "w8a8" where
        # the JAX package's projections are plain Dense layers
        self.quant = (cfg.quant == "w8a8" and cfg.attention_layout == "bhtd"
                      and not cfg.fused_qkv)
        linear = (functools.partial(QuantLinear, fold_scales=True)
                  if self.quant else Linear)
        if cfg.fused_qkv:
            self.qkv_proj = Linear(c, 3 * c)  # q, k and v weights stacked
        else:
            self.q_proj = linear(c, c)
            self.k_proj = linear(c, c)
            self.v_proj = linear(c, c)
        self.out_proj = linear(c, c)

    def forward(self, x, lengths):  # (B, T, C); a time shard under SP
        axis = self.model_axis
        x = _column_input(x, axis)
        b, t, c = x.shape
        d = self.cfg.head_dim

        def to_heads(y):  # (B, T, H·D) -> a (B, H, T, D) view, no copy
            return y.view(b, t, y.shape[-1] // d, d).transpose(1, 2)

        if self.cfg.fused_qkv:
            # views of one (B, T, 3C) product: the kernels read its 3C time
            # stride, and autograd stacks dq, dk and dv into its gradient;
            # on the model axis the product is whole on every process,
            # which reads its own heads (its gradient summed over the axis)
            w, bias = (copy_to_model(p, axis) for p in (
                self.qkv_proj.weight, self.qkv_proj.bias))
            own = slice(None) if axis is None else axis.shard(c)
            q, k, v = (to_heads(y[..., own]) for y in F.linear(
                x, w.to(x.dtype), bias.to(x.dtype)).split(c, -1))
        else:
            # q, k and v quantize x to the same codes: once, shared
            shared = {"x_codes": quantize_rows(x)} if self.quant else {}
            q, k, v = (to_heads(proj(x, **shared))
                       for proj in (self.q_proj, self.k_proj, self.v_proj))
        ctx = multi_head_attention_bhtd(q, k, v, lengths)
        # free when the kernel wrote its (B, T, H, D) buffer
        out = _row_parallel(self.out_proj,
                            ctx.transpose(1, 2).reshape(b, t, -1), axis)
        return _dropout(out, self.cfg.attention_dropout, self.training)


class FeedForward(nn.Module):
    """The GELU FFN. On the model axis each process holds its slice of the
    hidden units: rows of the first Linear (column-parallel), columns of
    the second (row-parallel); its dropout after the GELU draws a mask of
    its own for its units."""

    model_axis = None

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        linear = (functools.partial(QuantLinear, fold_scales=False)
                  if cfg.quant in ("w8a8_ffn", "w8a8") else Linear)
        self.intermediate_dense = linear(cfg.hidden_size,
                                         cfg.intermediate_size)
        self.output_dense = linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        axis = self.model_axis
        h = _gelu(self.intermediate_dense(_column_input(x, axis)), self.cfg)
        h = _dropout(h, self.cfg.activation_dropout, self.training)
        h = _row_parallel(self.output_dense, h, axis)
        return _dropout(h, self.cfg.hidden_dropout, self.training)


class EncoderLayer(nn.Module):
    """Pre-norm transformer layer. Its sublayers compute in the compute
    dtype; the residual adds keep the stream's dtype (float32 under
    ``do_stable_layer_norm=False``), as the JAX package's type promotion
    does. Under sequence parallelism (``model_axis.sequence``) it takes
    and returns this process's time shard of the residual stream, and its
    LayerNorms, residual adds and dropouts act on that shard."""

    model_axis = None

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = SelfAttention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)

    def forward(self, x, lengths):
        axis = self.model_axis
        sp = axis if axis is not None and axis.sequence else None
        x = x + self.attention(
            _layer_norm(self.layer_norm, x, self.dtype, sp), lengths)
        return x + self.feed_forward(
            _layer_norm(self.final_layer_norm, x, self.dtype, sp))


# the dense products F.linear and torch.matmul dispatch to: the ops whose
# outputs remat "dots" saves (JAX's dots_saveable saves dot_general's)
DENSE_PRODUCTS = frozenset((torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default,
                            torch.ops.aten.bmm.default,
                            torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the dense products' outputs, recompute everything else: casts,
    LayerNorm, GELU, dropout (its masks redrawn from the restored RNG
    state) and attention, whose kernel allocates its outputs with
    ``torch.empty`` and is launched again."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in DENSE_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


class Encoder(nn.Module):
    """The positional conv and the transformer stack. Under sequence
    parallelism (``model_axis.sequence``) the stack runs on time shards:
    the sequence is padded to a multiple of the model axis's size (the pad
    frames lie past every length, so no valid frame attends to them) and
    split, and gathered again after the last layer."""

    model_axis = None

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, frame_lengths, output_hidden_states: bool = False,
                layer_stack_fn=None):
        """``layer_stack_fn``: a callable ``(h, frame_lengths) -> h`` that
        replaces the transformer-layer loop (the pipe axis's schedule,
        ``parallel/pipeline.py``), between the positional conv and the
        final LayerNorm; no sequence parallelism under it."""
        if layer_stack_fn is not None and output_hidden_states:
            raise ValueError(
                "layer_stack_fn and output_hidden_states are exclusive: "
                "an external stack executor returns only the final state")
        stable = self.cfg.do_stable_layer_norm
        h = h + self.pos_conv_embed(h)
        if not stable:
            # the JAX package's LayerNorm here has no dtype: its float32
            # parameters promote its output, and so the residual stream,
            # to float32
            h = _layer_norm(self.layer_norm, h, torch.float32)
        h = _dropout(h, self.cfg.hidden_dropout, self.training)
        if layer_stack_fn is not None:
            h = layer_stack_fn(h, frame_lengths)
            return (_layer_norm(self.layer_norm, h) if stable else h), None
        # per-layer recomputation in the backward, like the JAX package's
        # nn.remat (with jax.checkpoint_policies.dots_saveable for "dots");
        # only while training with a gradient to take
        remat = (self.cfg.remat_policy != "none" and self.training
                 and torch.is_grad_enabled())
        kwargs = ({"context_fn": _DOTS_CONTEXT}
                  if self.cfg.remat_policy == "dots" else {})
        all_hidden = [h] if output_hidden_states else None
        axis = self.model_axis
        sp = axis is not None and axis.sequence
        t = h.shape[1]
        if sp:
            h = scatter_time(F.pad(h, (0, 0, 0, -t % axis.size)), axis)

        def whole(x):  # the whole sequence from this process's shard
            return gather_time_replicated(x, axis)[:, :t] if sp else x

        for i, layer in enumerate(self.layers):
            if remat:
                h = checkpoint(layer, h, frame_lengths, use_reentrant=False,
                               **kwargs)
            else:
                h = layer(h, frame_lengths)
            if output_hidden_states and i < len(self.layers) - 1:
                all_hidden.append(whole(h))
        h = whole(h)
        if stable:
            h = _layer_norm(self.layer_norm, h)
        if output_hidden_states:
            # HF indexing: entry N (the number of layers) is the encoder's
            # output (after the final LayerNorm when there is one)
            all_hidden.append(h)
        return h, all_hidden


def sample_span_starts(generator: Optional[torch.Generator],
                       lengths: torch.Tensor, t: int, prob: float,
                       span: int, min_masks: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SpecAugment span sampling, the JAX package's ``_compute_time_mask``:
    per item about ``prob · length / span`` spans (stochastic rounding, at
    least ``min_masks``, at most ``max(int(prob · t / span) + 1,
    min_masks)``), each starting uniformly in ``[0, max(length − span, 1))``.
    Returns ``(starts, n_spans)``: (B, max_spans) int32 starts, of which the
    first ``n_spans[b]`` are used. Draws from ``generator`` (the default
    generator of ``lengths``' device when None); in a data-parallel step
    the draws are the global batch's, of which this process keeps its
    rows (``parallel/global_batch.py``)."""
    b = lengths.shape[0]
    dev = lengths.device
    rows, lo = global_rows(b)
    max_starts = max(int(prob * t / span) + 1, min_masks)
    expected = prob * lengths.float() / span
    frac = expected - torch.floor(expected)
    extra = (torch.rand(rows, generator=generator, device=dev)[lo:lo + b]
             < frac).int()
    n_spans = (torch.floor(expected).int() + extra).clamp(min=min_masks)
    n_spans = n_spans.clamp(max=max_starts)
    u = torch.rand((rows, max_starts), generator=generator,
                   device=dev)[lo:lo + b]
    starts = (u * (lengths[:, None] - span).clamp(min=1)).int()
    return starts, n_spans


def spans_to_mask(starts: torch.Tensor, n_spans: torch.Tensor, t: int,
                  span: int) -> torch.Tensor:
    """(B, T) bool, True inside the first ``n_spans[b]`` spans of
    ``span`` frames from ``starts``."""
    pos = torch.arange(t, device=starts.device)[None, None, :]
    in_span = ((pos >= starts[:, :, None])
               & (pos < starts[:, :, None] + span))
    used = (torch.arange(starts.shape[1], device=starts.device)[None, :]
            < n_spans[:, None])
    return (in_span & used[:, :, None]).any(dim=1)


def compute_time_mask(generator: Optional[torch.Generator],
                      lengths: torch.Tensor, t: int, prob: float, span: int,
                      min_masks: int) -> torch.Tensor:
    """The SpecAugment span mask (True = masked), (B, T)."""
    return spans_to_mask(*sample_span_starts(generator, lengths, t, prob,
                                             span, min_masks), t, span)


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> None:
    """Turn the Linear and Conv1d parameters under ``module`` into
    ``dtype`` in place (serving: the in-op casts then do nothing).
    LayerNorm, weight-norm g/v, embeddings and the quantized Linears (whose
    codes come from their float32 weights) stay float32."""
    for m in module.modules():
        if (isinstance(m, (nn.Linear, nn.Conv1d))
                and not isinstance(m, QuantLinear)):
            m.to(dtype)


class Wav2Vec2Model(nn.Module):
    """Backbone: feature extractor → projection → transformer stack.

    ``forward(input_values, input_lengths)`` returns ``(hidden_states,
    frame_lengths, extract_features)``: the encoder's output (B, T,
    hidden; the final LayerNorm's, or under ``do_stable_layer_norm=False``
    the last layer's, in float32), the int32 valid frame count per item,
    and the conv features (B, T, conv_dim[-1]); with
    ``output_hidden_states`` a fourth item, the list of
    ``num_hidden_layers + 1`` hidden states in HF indexing.
    """

    def __init__(self, cfg: Wav2Vec2Config,
                 freeze_feature_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.freeze_feature_encoder = freeze_feature_encoder
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        if cfg.apply_spec_augment:
            # SpecAugment's learned mask embedding
            self.masked_spec_embed = nn.Parameter(
                torch.rand(cfg.hidden_size))

    def forward(self, input_values: Optional[torch.Tensor],
                input_lengths: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False,
                time_mask: Optional[torch.Tensor] = None,
                precomputed_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                layer_stack_fn=None):
        """``time_mask`` (B, T_frames) bool, True = masked: replaces the
        sampled SpecAugment time mask, in either mode. ``precomputed_
        features`` (B, T_frames, conv_dim[-1]): the feature extractor's
        output, replacing its forward (``input_values`` may then be None;
        ``input_lengths`` stays in audio samples). ``generator``: the
        source of SpecAugment's random spans in ``train()`` mode (dropout
        draws from the default generator). ``layer_stack_fn``: replaces
        the encoder's layer loop (``Encoder.forward``); it excludes
        ``output_hidden_states``."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        if precomputed_features is not None:
            if input_lengths is None:
                raise ValueError("precomputed_features needs input_lengths "
                                 "(audio samples) for the frame masks")
            feats = precomputed_features.to(dtype)
        else:
            b, l = input_values.shape
            if input_lengths is None:
                input_lengths = torch.full((b,), l, dtype=torch.int32,
                                           device=input_values.device)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.freeze_feature_encoder):
                feats = self.feature_extractor(input_values.to(dtype))
        t = feats.shape[1]
        frame_lengths = cfg.feat_extract_output_lengths(
            input_lengths.to(torch.int32))
        frame_mask = (torch.arange(t, device=feats.device)[None, :]
                      < frame_lengths[:, None])
        h = self.feature_projection(feats)
        h = self._spec_augment(h, frame_lengths, frame_mask, time_mask,
                               generator)
        # pad frames are zeroed before the positional conv
        h = h * frame_mask[:, :, None].to(h.dtype)
        h, all_hidden = self.encoder(h, frame_lengths, output_hidden_states,
                                     layer_stack_fn)
        if output_hidden_states:
            return h, frame_lengths, feats, all_hidden
        return h, frame_lengths, feats

    def _spec_augment(self, h, frame_lengths, frame_mask, time_mask,
                      generator):
        cfg = self.cfg
        train = self.training and cfg.apply_spec_augment
        if time_mask is not None:
            if not cfg.apply_spec_augment:
                raise ValueError("an external time_mask needs "
                                 "cfg.apply_spec_augment (the learned mask "
                                 "embedding)")
            mask = time_mask.to(h.device) & frame_mask
        elif train and cfg.mask_time_prob > 0:
            mask = compute_time_mask(
                generator, frame_lengths, h.shape[1], cfg.mask_time_prob,
                cfg.mask_time_length, cfg.mask_time_min_masks) & frame_mask
        else:
            mask = None
        if mask is not None:
            h = torch.where(mask[:, :, None],
                            self.masked_spec_embed.to(h.dtype), h)
        if train and cfg.mask_feature_prob > 0:
            b, _, c = h.shape
            feat_mask = compute_time_mask(
                generator, torch.full((b,), c, dtype=torch.int32,
                                      device=h.device),
                c, cfg.mask_feature_prob, cfg.mask_feature_length,
                cfg.mask_feature_min_masks)  # (B, C)
            h = h.masked_fill(feat_mask[:, None, :], 0.0)
        return h


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in the JAX package's
    distributions: LeCun-normal Linear/Conv1d weights (std 1/√fan_in),
    zero biases, unit LayerNorm scales, weight-norm ``v`` normal with std
    4/√(k·C) and ``g`` ones, LSTM tensors uniform in ±1/√H, embeddings
    normal with std 1/√dim (the padding row zero). Draws in float32 on the
    generator's device, then casts into each parameter."""
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
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / np.sqrt(m.hidden_size)
            for p in m.parameters():
                p.copy_(torch.rand(p.shape, generator=generator, device=dev)
                        * (2 * bound) - bound)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0 / np.sqrt(m.embedding_dim))
            if m.padding_idx is not None:
                m.weight[m.padding_idx].zero_()
        elif isinstance(m, Wav2Vec2Model) and hasattr(m, "masked_spec_embed"):
            m.masked_spec_embed.copy_(torch.rand(
                m.masked_spec_embed.shape, generator=generator, device=dev))
