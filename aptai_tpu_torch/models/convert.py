"""Weight bridge from the JAX package's parameter trees.

:func:`state_dict_from_jax` takes the JAX ``APTAI`` parameters (nested
dicts of arrays: ``{"encoder": ..., "tv_linear": ..., "phn_linear": ...}``)
and returns this package's ``APTAI`` state_dict: HF ``Wav2Vec2Model`` names
under ``wav2vec2.``, plus ``tv_linear`` and ``phn_linear``.
:func:`w2v2_pr_state_dict_from_jax` does the same for ``W2V2PR``
(``{"encoder", "pr_head"}`` → ``wav2vec2.*`` and ``pr_head``, the layout of
the JAX package's ``export_w2v2_pr``),
:func:`force_aptai_state_dict_from_jax` for ``ForceAPTAI`` (the tower under
``w2v2_pr.``, then the head) and :func:`pretrain_state_dict_from_jax` for
``Wav2Vec2Pretrain`` (``{"encoder", "quantizer", "project_hid",
"project_q"}`` → HF ``Wav2Vec2ForPreTraining`` names).
:func:`fuse_qkv_state_dict` turns HF q/k/v names into a ``fused_qkv``
encoder's ``qkv_proj``. Layouts:

* conv kernel (k, Cin, Cout) → (Cout, Cin, k)
* Dense kernel (in, out) → (out, in), ``fused_qkv``'s ``qkv_proj`` too;
  LayerNorm ``scale`` → ``weight``
* weight-norm ``weight_v`` (k, in/g, C) → (C, in/g, k) and
  ``weight_g`` (k, 1, 1) → (1, 1, k)
* LSTM ``w_ih_fwd``, ``w_hh_fwd``, ``b_ih_fwd``, ``b_hh_fwd`` (torch layout
  already) → ``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``,
  ``bias_hh_l0``; the ``_bwd`` ones → the same names with ``_reverse``
* ``Embed`` ``embedding`` (V, D) → ``weight``

A gradient tree has the parameter tree's structure, so ``jax.grad`` of the
JAX model crosses the same bridge into gradients named like this package's
parameters (the tests compare ``.grad`` with it).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor of an array leaf (a tensor leaf too: the flax
    reader gives bfloat16 leaves as tensors, numpy having no bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], base: str, leaf: Mapping) -> None:
    """A flax Dense leaf into ``sd`` as ``<base>.weight`` / ``.bias``."""
    sd[f"{base}.weight"] = _t(leaf["kernel"]).T.contiguous()
    sd[f"{base}.bias"] = _t(leaf["bias"])


def encoder_state_dict_from_jax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Wav2Vec2Encoder`` tree → HF ``Wav2Vec2Model`` names."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, kernel):
        sd[key] = _t(kernel).permute(2, 1, 0).contiguous()

    def ln(base, leaf):
        sd[f"{base}.weight"] = _t(leaf["scale"])
        sd[f"{base}.bias"] = _t(leaf["bias"])

    fe = enc["feature_extractor"]
    for i in range(len(fe)):
        layer, base = fe[f"layers_{i}"], f"feature_extractor.conv_layers.{i}"
        conv(f"{base}.conv.weight", layer["conv"]["kernel"])
        if "bias" in layer["conv"]:
            sd[f"{base}.conv.bias"] = _t(layer["conv"]["bias"])
        if "layer_norm" in layer:
            ln(f"{base}.layer_norm", layer["layer_norm"])

    ln("feature_projection.layer_norm",
       enc["feature_projection"]["layer_norm"])
    _dense(sd, "feature_projection.projection",
           enc["feature_projection"]["projection"])
    if "masked_spec_embed" in enc:
        sd["masked_spec_embed"] = _t(enc["masked_spec_embed"])

    pc = enc["pos_conv_embed"]
    conv("encoder.pos_conv_embed.conv.weight_g", pc["weight_g"])
    conv("encoder.pos_conv_embed.conv.weight_v", pc["weight_v"])
    sd["encoder.pos_conv_embed.conv.bias"] = _t(pc["bias"])

    i = 0
    while f"layers_{i}" in enc:
        layer, p = enc[f"layers_{i}"], f"encoder.layers.{i}"
        ln(f"{p}.layer_norm", layer["layer_norm"])
        ln(f"{p}.final_layer_norm", layer["final_layer_norm"])
        # fused_qkv: one qkv_proj Dense, kernel (C, 3C) → weight (3C, C)
        for name in layer["attention"]:
            _dense(sd, f"{p}.attention.{name}", layer["attention"][name])
        _dense(sd, f"{p}.feed_forward.intermediate_dense",
               layer["feed_forward"]["intermediate_dense"])
        _dense(sd, f"{p}.feed_forward.output_dense",
               layer["feed_forward"]["output_dense"])
        i += 1

    ln("encoder.layer_norm", enc["layer_norm"])
    return sd


_Q_PROJ = re.compile(
    r"(.*encoder\.layers\.\d+\.attention\.)q_proj\.(weight|bias)")


def fuse_qkv_state_dict(sd: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """An encoder state dict with HF names (bare or under a prefix) for a
    ``fused_qkv`` encoder: each layer's ``q_proj``, ``k_proj`` and
    ``v_proj`` weights and biases concatenated, in that order, into its
    ``qkv_proj``, as the JAX package's
    ``convert_wav2vec2_encoder(fused_qkv=True)`` builds its kernel."""
    out = dict(sd)
    for k in sd:
        m = _Q_PROJ.fullmatch(k)
        if m:
            base, leaf = m.groups()
            parts = [out.pop(f"{base}{n}_proj.{leaf}") for n in "qkv"]
            out[f"{base}qkv_proj.{leaf}"] = torch.cat(parts)
    return out


def _model_state_dict(params: Mapping, heads) -> Dict[str, torch.Tensor]:
    sd = {f"wav2vec2.{k}": v for k, v in
          encoder_state_dict_from_jax(params["encoder"]).items()}
    for head in heads:
        _dense(sd, head, params[head])
    return sd


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``APTAI`` parameter tree → this package's ``APTAI``
    state_dict (float32 CPU tensors; ``load_state_dict`` casts them into
    the model's dtypes)."""
    return _model_state_dict(params, ("tv_linear", "phn_linear"))


def w2v2_pr_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``W2V2PR`` parameter tree → this package's ``W2V2PR``
    state_dict (float32 CPU tensors)."""
    return _model_state_dict(params, ("pr_head",))


def pretrain_state_dict_from_jax(params: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The JAX ``Wav2Vec2Pretrain`` parameter tree → this package's
    ``Wav2Vec2Pretrain`` state_dict (float32 CPU tensors): the encoder
    under ``wav2vec2.``, ``quantizer.codevectors`` as it is, and the
    quantizer's ``weight_proj`` and the two projections transposed."""
    sd = _model_state_dict(params, ("project_hid", "project_q"))
    quantizer = params["quantizer"]
    sd["quantizer.codevectors"] = _t(quantizer["codevectors"])
    _dense(sd, "quantizer.weight_proj", quantizer["weight_proj"])
    return sd


def force_aptai_state_dict_from_jax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX ``ForceAPTAI`` parameter tree → this package's
    ``ForceAPTAI`` state_dict (float32 CPU tensors)."""
    sd = {f"w2v2_pr.{k}": v for k, v in
          w2v2_pr_state_dict_from_jax(params["w2v2_pr"]).items()}
    return {**sd, **force_head_state_dict_from_jax(params)}


def force_head_state_dict_from_jax(params: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """The head entries (all but the ``w2v2_pr`` tower) of a JAX
    ``ForceAPTAI`` tree → this package's names; a tree without the tower
    (the JAX trainer's head-only checkpoints) crosses whole."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "frame_lin", params["frame_lin"])
    xatt = params["xatt"]
    _dense(sd, "xatt.q", xatt["q"])
    _dense(sd, "xatt.k", xatt["k"])
    sd["xatt.layer_norm.weight"] = _t(xatt["layer_norm"]["scale"])
    sd["xatt.layer_norm.bias"] = _t(xatt["layer_norm"]["bias"])
    sd["phn_encoder.embed.weight"] = _t(
        params["phn_encoder"]["embed"]["embedding"])
    rnn = params["rnn"]
    for jax_dir, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for jax_name, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"rnn.lstm.{name}_l0{suffix}"] = _t(rnn[f"{jax_name}_"
                                                       f"{jax_dir}"])
    _dense(sd, "rnn.linear_0", rnn["linear_0"])
    _dense(sd, "rnn.linear_1", rnn["linear_1"])
    return sd


def any_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of any of the four families (APTAI, W2V2PR,
    ForceAPTAI, Wav2Vec2Pretrain) → this package's state_dict, the family
    read from the tree's top-level keys (a FORCE tree without the tower
    gives the head's entries only)."""
    if "quantizer" in params:
        return pretrain_state_dict_from_jax(params)
    if "pr_head" in params:
        return w2v2_pr_state_dict_from_jax(params)
    if "tv_linear" in params:
        return state_dict_from_jax(params)
    if "frame_lin" in params:
        if "w2v2_pr" in params:
            return force_aptai_state_dict_from_jax(params)
        return force_head_state_dict_from_jax(params)
    raise ValueError(f"not a JAX APTAI, W2V2PR, ForceAPTAI or "
                     f"Wav2Vec2Pretrain parameter tree: top-level keys "
                     f"{sorted(params)}")
