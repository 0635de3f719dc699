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

The way back: :func:`jax_params_from_state_dict` (APTAI),
:func:`jax_w2v2_pr_params_from_state_dict`,
:func:`jax_pretrain_params_from_state_dict`,
:func:`jax_force_aptai_params_from_state_dict` (whole or head-only) and
:func:`jax_encoder_params_from_state_dict` invert each layout exactly, the
tree's shape read from the state dict's names (feature-extractor layers
with or without ``layer_norm`` and conv bias, ``masked_spec_embed``,
``fused_qkv``'s ``qkv_proj``); :func:`jax_params_from_any_state_dict`
finds the family as :func:`any_state_dict_from_jax` does. Leaves are
contiguous float32 tensors on the state dict's device (the JAX trainers
hold float32 parameters), so a checkpoint's transposes run on the card
before the copy to the host; a name the family does not have raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

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


def jax_tree_family(params) -> Optional[str]:
    """The family of a JAX parameter tree by its top-level keys, named as
    :func:`state_dict_family` names them; None for another tree."""
    if not isinstance(params, Mapping):
        return None
    if "quantizer" in params:
        return "pretrain"
    if "pr_head" in params:
        return "w2v2_pr"
    if "tv_linear" in params:
        return "aptai"
    if "frame_lin" in params:
        return "force_aptai" if "w2v2_pr" in params else "force_head"
    return None


def any_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of any of the four families (APTAI, W2V2PR,
    ForceAPTAI, Wav2Vec2Pretrain) → this package's state_dict, the family
    read from the tree's top-level keys (a FORCE tree without the tower
    gives the head's entries only)."""
    family = jax_tree_family(params)
    if family is None:
        raise ValueError(f"not a JAX APTAI, W2V2PR, ForceAPTAI or "
                         f"Wav2Vec2Pretrain parameter tree: top-level keys "
                         f"{sorted(params)}")
    return {"pretrain": pretrain_state_dict_from_jax,
            "w2v2_pr": w2v2_pr_state_dict_from_jax,
            "aptai": state_dict_from_jax,
            "force_aptai": force_aptai_state_dict_from_jax,
            "force_head": force_head_state_dict_from_jax}[family](params)


# -- this package's state dicts → the JAX package's parameter trees ------------

class _Entries:
    """A state dict read entry by entry; :meth:`done` raises for entries
    no one took, so a name the family does not have cannot be dropped."""

    def __init__(self, sd: Mapping):
        self.rest = dict(sd)

    def __contains__(self, key) -> bool:
        return key in self.rest

    def take(self, key) -> torch.Tensor:
        return self.rest.pop(key).detach().to(dtype=torch.float32)

    def conv(self, key) -> torch.Tensor:
        """(Cout, Cin, k) → (k, Cin, Cout); weight-norm g and v too."""
        return self.take(key).permute(2, 1, 0).contiguous()

    def dense(self, base: str) -> Dict[str, torch.Tensor]:
        return {"kernel": self.take(f"{base}.weight").T.contiguous(),
                "bias": self.take(f"{base}.bias")}

    def layer_norm(self, base: str) -> Dict[str, torch.Tensor]:
        return {"scale": self.take(f"{base}.weight"),
                "bias": self.take(f"{base}.bias")}

    def done(self, family: str) -> None:
        if self.rest:
            raise ValueError(f"{family} state dict has entries with no JAX "
                             f"counterpart: {sorted(self.rest)[:8]}")


def _jax_encoder(e: _Entries) -> Dict:
    fe, i = {}, 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in e:
        base = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": e.conv(f"{base}.conv.weight")}
        if f"{base}.conv.bias" in e:
            conv["bias"] = e.take(f"{base}.conv.bias")
        layer = {"conv": conv}
        if f"{base}.layer_norm.weight" in e:
            layer["layer_norm"] = e.layer_norm(f"{base}.layer_norm")
        fe[f"layers_{i}"] = layer
        i += 1
    enc = {"feature_extractor": fe, "feature_projection": {
        "layer_norm": e.layer_norm("feature_projection.layer_norm"),
        "projection": e.dense("feature_projection.projection")}}
    if "masked_spec_embed" in e:
        enc["masked_spec_embed"] = e.take("masked_spec_embed")
    pc = "encoder.pos_conv_embed.conv"
    enc["pos_conv_embed"] = {"weight_g": e.conv(f"{pc}.weight_g"),
                             "weight_v": e.conv(f"{pc}.weight_v"),
                             "bias": e.take(f"{pc}.bias")}
    i = 0
    while f"encoder.layers.{i}.layer_norm.weight" in e:
        p = f"encoder.layers.{i}"
        names = [n for n in ("q_proj", "k_proj", "v_proj", "qkv_proj",
                             "out_proj")
                 if f"{p}.attention.{n}.weight" in e]
        enc[f"layers_{i}"] = {
            "attention": {n: e.dense(f"{p}.attention.{n}") for n in names},
            "layer_norm": e.layer_norm(f"{p}.layer_norm"),
            "feed_forward": {
                n: e.dense(f"{p}.feed_forward.{n}")
                for n in ("intermediate_dense", "output_dense")},
            "final_layer_norm": e.layer_norm(f"{p}.final_layer_norm")}
        i += 1
    enc["layer_norm"] = e.layer_norm("encoder.layer_norm")
    return enc


def jax_encoder_params_from_state_dict(sd: Mapping) -> Dict:
    """HF ``Wav2Vec2Model`` names → the JAX ``Wav2Vec2Encoder`` tree: the
    inverse of :func:`encoder_state_dict_from_jax`."""
    e = _Entries(sd)
    enc = _jax_encoder(e)
    e.done("an encoder")
    return enc


def jax_params_from_state_dict(sd: Mapping) -> Dict:
    """This package's ``APTAI`` state dict → the JAX ``APTAI`` tree: the
    inverse of :func:`state_dict_from_jax`."""
    return _model_tree(sd, ("tv_linear", "phn_linear"), "an APTAI")


def jax_w2v2_pr_params_from_state_dict(sd: Mapping) -> Dict:
    """This package's ``W2V2PR`` state dict → the JAX ``W2V2PR`` tree."""
    return _model_tree(sd, ("pr_head",), "a W2V2PR")


def jax_pretrain_params_from_state_dict(sd: Mapping) -> Dict:
    """This package's ``Wav2Vec2Pretrain`` state dict → the JAX tree."""
    def quantizer(e):
        return {"quantizer": {"codevectors": e.take("quantizer.codevectors"),
                              "weight_proj": e.dense("quantizer.weight_proj")}}
    return _model_tree(sd, ("project_hid", "project_q"),
                       "a Wav2Vec2Pretrain", quantizer)


def _model_tree(sd: Mapping, heads, family: str, extra=None) -> Dict:
    """``{"encoder": ..., <heads>...}`` of a model whose encoder is under
    ``wav2vec2.``; every entry must be taken."""
    tree = {"encoder": jax_encoder_params_from_state_dict(
        {k[len("wav2vec2."):]: v for k, v in sd.items()
         if k.startswith("wav2vec2.")})}
    e = _Entries({k: v for k, v in sd.items()
                  if not k.startswith("wav2vec2.")})
    tree.update({h: e.dense(h) for h in heads})
    if extra is not None:
        tree.update(extra(e))
    e.done(family)
    return tree


def jax_force_aptai_params_from_state_dict(sd: Mapping) -> Dict:
    """This package's ``ForceAPTAI`` state dict → the JAX tree: the tower
    (``w2v2_pr.``) under ``"w2v2_pr"``, then the head; a state dict
    without the tower gives the head-only tree of the JAX trainer's cache
    mode."""
    tower = {k[len("w2v2_pr."):]: v for k, v in sd.items()
             if k.startswith("w2v2_pr.")}
    e = _Entries({k: v for k, v in sd.items()
                  if not k.startswith("w2v2_pr.")})
    rnn = {}
    for jax_dir, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for jax_name, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            rnn[f"{jax_name}_{jax_dir}"] = e.take(
                f"rnn.lstm.{name}_l0{suffix}").contiguous()
    rnn["linear_0"] = e.dense("rnn.linear_0")
    rnn["linear_1"] = e.dense("rnn.linear_1")
    tree = {"frame_lin": e.dense("frame_lin"),
            "xatt": {"q": e.dense("xatt.q"), "k": e.dense("xatt.k"),
                     "layer_norm": e.layer_norm("xatt.layer_norm")},
            "phn_encoder": {"embed": {
                "embedding": e.take("phn_encoder.embed.weight")}},
            "rnn": rnn}
    e.done("a ForceAPTAI head")
    if tower:
        tree["w2v2_pr"] = jax_w2v2_pr_params_from_state_dict(tower)
    return tree


def state_dict_family(sd: Mapping) -> Optional[str]:
    """``"pretrain"``, ``"w2v2_pr"``, ``"aptai"``, ``"force_aptai"`` (the
    tower's entries present) or ``"force_head"`` by the state dict's
    names, as :func:`any_state_dict_from_jax` reads a JAX tree's keys;
    None for another tree."""
    if "quantizer.codevectors" in sd:
        return "pretrain"
    if "pr_head.weight" in sd:
        return "w2v2_pr"
    if "tv_linear.weight" in sd:
        return "aptai"
    if "frame_lin.weight" in sd:
        return ("force_aptai" if any(k.startswith("w2v2_pr.") for k in sd)
                else "force_head")
    return None


def jax_params_from_any_state_dict(sd: Mapping) -> Dict:
    """A state dict of any of the four families → the JAX parameter tree,
    the family read from its names (:func:`state_dict_family`): the
    inverse of :func:`any_state_dict_from_jax`."""
    family = state_dict_family(sd)
    if family is None:
        raise ValueError("not an APTAI, W2V2PR, ForceAPTAI or "
                         "Wav2Vec2Pretrain state dict: names "
                         f"{sorted(sd)[:8]}")
    return {"pretrain": jax_pretrain_params_from_state_dict,
            "w2v2_pr": jax_w2v2_pr_params_from_state_dict,
            "aptai": jax_params_from_state_dict,
            "force_aptai": jax_force_aptai_params_from_state_dict,
            "force_head": jax_force_aptai_params_from_state_dict}[family](sd)
