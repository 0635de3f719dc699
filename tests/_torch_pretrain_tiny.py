"""Shared by ``test_torch_pretrain.py`` and ``test_torch_pretrain_runs.py``:
the tiny pretraining config and head, the port state dict → JAX tree
conversion, the noisy random JAX trees, and the models of both packages
on them.
"""

from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import pretrain as jpre_model
from aptai_tpu.models.hf_convert import convert_wav2vec2_encoder
from aptai_tpu_torch.models.convert import pretrain_state_dict_from_jax
from aptai_tpu_torch.models.pretrain import Wav2Vec2Pretrain

from _torch_port import NO_DROP, _noisy_state_dict


STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
TINY = dict(STACK, **NO_DROP, apply_spec_augment=True, mask_time_prob=0.0)
HEAD = dict(num_groups=2, num_vars=8, codevector_dim=16,
            proj_codevector_dim=16, num_negatives=10)
LOSS_REL = 1e-5


OUTPUTS = ("loss", "contrastive_loss", "diversity_loss", "feature_penalty",
           "codebook_perplexity", "contrastive_accuracy", "num_masked",
           "frame_lengths")


def jax_tree(sd, num_layers):
    """A port ``Wav2Vec2Pretrain`` state dict (numpy) → the JAX tree."""
    dense = lambda n: {"kernel": sd[f"{n}.weight"].T.copy(),
                       "bias": sd[f"{n}.bias"]}
    return {"encoder": convert_wav2vec2_encoder(sd, num_layers,
                                                prefix="wav2vec2."),
            "quantizer": {"codevectors": sd["quantizer.codevectors"],
                          "weight_proj": dense("quantizer.weight_proj")},
            "project_hid": dense("project_hid"),
            "project_q": dense("project_q")}


def random_jax_params(cfg_t, seed, **head):
    """The JAX tree of a port model with noisy random weights."""
    model = Wav2Vec2Pretrain(cfg_t, **{**HEAD, **head})
    return jax_tree(_noisy_state_dict(model, seed), cfg_t.num_hidden_layers)


def port_from_jax(cfg_t, params, **head):
    model = Wav2Vec2Pretrain(cfg_t, **{**HEAD, **head})
    model.load_state_dict(pretrain_state_dict_from_jax(params), strict=True)
    return model


def jax_model(**head):
    return jpre_model.Wav2Vec2Pretrain(jcfg.tiny_config(**TINY),
                                       **{**HEAD, **head})


def _rel_close(got, want, what, rel=LOSS_REL):
    assert abs(got - want) <= rel * max(abs(want), 1e-6), (what, got, want)
