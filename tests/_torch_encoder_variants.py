"""Shared by ``test_torch_encoder_variants.py`` and
``test_torch_encoder_variants_train.py``: the tiny encoder's inputs, the
HF state dict with its JAX trees for each variant, and the port's encoder
run on them.
"""

import numpy as np
import torch

from aptai_tpu.models.hf_convert import convert_wav2vec2_encoder
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.models.convert import encoder_state_dict_from_jax

from _torch_port import random_jax_aptai_params


NUM_PHN = 11
VARIANTS = {
    "fused_qkv": dict(fused_qkv=True),
    "bthd": dict(attention_layout="bthd"),
    "non_stable": dict(do_stable_layer_norm=False),
    "all_three": dict(fused_qkv=True, attention_layout="bthd",
                      do_stable_layer_norm=False),
}


def _layout(name):
    return ({"attention_layout": "bthd"} if name == "bthd"
            else {"fused_qkv": True})


def _inputs():
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    audio[1, 2500:] = 0.0
    return audio, np.array([4000, 2500], np.int32)


def _hf_and_trees(cfg, seed):
    """HF-named encoder tensors (numpy) drawn from ``seed``, and the JAX
    trees ``convert_wav2vec2_encoder`` builds from them: q, k and v apart
    and fused."""
    params = random_jax_aptai_params(cfg, NUM_PHN, seed)
    hf = {k: v.numpy() for k, v in
          encoder_state_dict_from_jax(params["encoder"]).items()}
    return hf, {fused: convert_wav2vec2_encoder(
        hf, cfg.num_hidden_layers, fused_qkv=fused == "fused")
        for fused in ("apart", "fused")}


def _tree(trees, cfg):
    return trees["fused" if cfg.fused_qkv else "apart"]


def _port(cfg, tree):
    model = tw2v.Wav2Vec2Model(cfg).eval()
    model.load_state_dict(encoder_state_dict_from_jax(tree), strict=True)
    return model


def _run_port(model, audio, lens, hidden=True):
    with torch.no_grad():
        return model(torch.from_numpy(audio), torch.from_numpy(lens),
                     output_hidden_states=hidden)
