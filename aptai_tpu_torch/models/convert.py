"""Weight bridge from the JAX package's parameter trees.

:func:`state_dict_from_jax` takes the JAX ``APTAI`` parameters (nested
dicts of arrays: ``{"encoder": ..., "tv_linear": ..., "phn_linear": ...}``)
and returns this package's ``APTAI`` state_dict: HF ``Wav2Vec2Model`` names
under ``wav2vec2.``, plus ``tv_linear`` and ``phn_linear``.
:func:`w2v2_pr_state_dict_from_jax` does the same for ``W2V2PR``
(``{"encoder", "pr_head"}`` → ``wav2vec2.*`` and ``pr_head``, the layout of
the JAX package's ``export_w2v2_pr``), and
:func:`force_aptai_state_dict_from_jax` for ``ForceAPTAI`` (the tower under
``w2v2_pr.``, then the head). Layouts:

* conv kernel (k, Cin, Cout) → (Cout, Cin, k)
* Dense kernel (in, out) → (out, in); LayerNorm ``scale`` → ``weight``
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

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def encoder_state_dict_from_jax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Wav2Vec2Encoder`` tree → HF ``Wav2Vec2Model`` names."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, kernel):
        sd[key] = _t(kernel).permute(2, 1, 0).contiguous()

    def dense(base, leaf):
        sd[f"{base}.weight"] = _t(leaf["kernel"]).T.contiguous()
        sd[f"{base}.bias"] = _t(leaf["bias"])

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
    dense("feature_projection.projection",
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
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.attention.{name}", layer["attention"][name])
        dense(f"{p}.feed_forward.intermediate_dense",
              layer["feed_forward"]["intermediate_dense"])
        dense(f"{p}.feed_forward.output_dense",
              layer["feed_forward"]["output_dense"])
        i += 1

    ln("encoder.layer_norm", enc["layer_norm"])
    return sd


def _model_state_dict(params: Mapping, heads) -> Dict[str, torch.Tensor]:
    sd = {f"wav2vec2.{k}": v for k, v in
          encoder_state_dict_from_jax(params["encoder"]).items()}
    for head in heads:
        sd[f"{head}.weight"] = _t(params[head]["kernel"]).T.contiguous()
        sd[f"{head}.bias"] = _t(params[head]["bias"])
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


def force_aptai_state_dict_from_jax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX ``ForceAPTAI`` parameter tree → this package's
    ``ForceAPTAI`` state_dict (float32 CPU tensors)."""
    sd = {f"w2v2_pr.{k}": v for k, v in
          w2v2_pr_state_dict_from_jax(params["w2v2_pr"]).items()}

    def dense(base, leaf):
        sd[f"{base}.weight"] = _t(leaf["kernel"]).T.contiguous()
        sd[f"{base}.bias"] = _t(leaf["bias"])

    dense("frame_lin", params["frame_lin"])
    xatt = params["xatt"]
    dense("xatt.q", xatt["q"])
    dense("xatt.k", xatt["k"])
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
    dense("rnn.linear_0", rnn["linear_0"])
    dense("rnn.linear_1", rnn["linear_1"])
    return sd
