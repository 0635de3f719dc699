"""Shared by ``test_torch_export.py`` and ``test_torch_export_contract.py``:
the tiny models of each family (the JAX trees, the JAX models and the
port's models on the same weights) and their serving bundles, each
exported and loaded on the CPU the first time a test asks for it.
"""

import numpy as np
import pytest

from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch.infer import export as texport
from aptai_tpu_torch.models import (ForceAPTAI,
                                    force_aptai_state_dict_from_jax,
                                    random_aptai, random_w2v2_pr)
from aptai_tpu_torch.models import configs as tcfg

from _torch_port import (NO_DROP, port_aptai_from_jax, port_w2v2_pr_from_jax,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)


CONVS = dict(conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
STACK = dict(NO_DROP, conv_dim=(16,) * 7, **CONVS)
# the encoder's three config variants together
VARIANTS = dict(STACK, fused_qkv=True, attention_layout="bthd",
                do_stable_layer_norm=False)
# C 128: the mid-stack layers qualify for the fused conv
FUSED = dict(NO_DROP, conv_dim=(128,) * 7, fused_feature_extractor=True,
             **CONVS)
V = 11
BATCH, SECONDS = 2, 1.0  # one whole-second bucket: the live batches' width
SAMPLES = int(SECONDS * 16_000)
FIELDS = {"aptai": ("tvs_pred", "phn_fc_pred"),
          "w2v2_pr": ("phoneme_logits",),
          "force_aptai": ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
                          "phn_seq_lengths")}
FRAME_FIELDS = {"tvs_pred", "phn_fc_pred", "phoneme_logits",
                "pred_frame_phns"}


def _wavs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(4000 + 4000 * i) * 0.1).astype(np.float32)
            for i in range(n)]


# -- bundles -------------------------------------------------------------------

def _port_models():
    """Per family: (JAX params, JAX model, the port's model, method). The
    W2V2PR graph and round trip use ``w2v2_pr_fused`` (its FE fused); the
    JAX parity uses the unfused ``w2v2_pr``."""
    cfg_t, cfg_j = tcfg.tiny_config(**STACK), jcfg.tiny_config(**STACK)
    p_a = random_jax_aptai_params(cfg_t, V, seed=70)
    p_w = random_jax_w2v2_pr_params(cfg_t, seed=71)
    p_f = random_jax_force_params(cfg_j, V, seed=72)

    def force(**kw):
        model = ForceAPTAI(cfg_t, vocab_size=V, **kw)
        model.load_state_dict(force_aptai_state_dict_from_jax(p_f),
                              strict=True)
        return model.eval()

    return {
        "aptai": (p_a, JaxAPTAI(cfg_j, num_phonemes=V),
                  port_aptai_from_jax(cfg_t, p_a, V), "predict"),
        "aptai_variants": (None, None, random_aptai(
            tcfg.tiny_config(**VARIANTS), seed=74, num_phonemes=V).eval(),
            "predict"),
        "w2v2_pr": (p_w, JaxW2V2PR(cfg_j), port_w2v2_pr_from_jax(cfg_t, p_w),
                    "encode"),
        "w2v2_pr_fused": (None, None, random_w2v2_pr(
            tcfg.tiny_config(**FUSED), seed=73).eval(), "encode"),
        "force_aptai": (p_f, JaxForceAPTAI(cfg_j, vocab_size=V), force(),
                        "predict"),
        "force_beam_device": (None, None, force(decode_method="beam_device"),
                              "predict"),
    }


def _family(name):
    return "w2v2_pr" if name.startswith("w2v2") else (
        "force_aptai" if name.startswith("force") else "aptai")


@pytest.fixture(scope="module")
def models():
    return _port_models()


# each bundle's wire encoding: int16 and μ-law are held to the live
# predictor with the same transfer, as float32 is
TRANSFER = {"aptai": "float32", "aptai_variants": "float32",
            "w2v2_pr_fused": "int16",
            "force_aptai": "float32", "force_beam_device": "uint8_mulaw"}


class _Bundles(dict):
    """Each port model's bundle (2 x 1 s, its family's fields, the
    transfer of :data:`TRANSFER`) as ``(directory, loaded bundle)``,
    exported and loaded on the CPU when first asked for."""

    def __init__(self, models, root):
        super().__init__()
        self.models, self.root = models, root

    def __contains__(self, name):
        return name in TRANSFER

    def __missing__(self, name):
        _, _, model, method = self.models[name]
        d = texport.save_serving_bundle(
            self.root / name, model, method=method, batch=BATCH,
            seconds=SECONDS, fields=FIELDS[_family(name)],
            transfer_dtype=TRANSFER[name], platforms=("cpu",),
            kind=_family(name))
        self[name] = (d, texport.load_serving_bundle(d, device="cpu"))
        return self[name]


@pytest.fixture(scope="module")
def bundles(models, tmp_path_factory):
    """The module's bundles, each exported once (:class:`_Bundles`)."""
    return _Bundles(models, tmp_path_factory.mktemp("bundles"))
