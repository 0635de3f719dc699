"""Shared helpers of the aptai_tpu_torch parity tests: random weights made
once and given to both packages.

The weights start in the torch port (HF names), get noise on every leaf so
biases and LayerNorm scales are not trivial zeros and ones, and cross to
the JAX tree through the JAX package's own HF converter — a fast path that
avoids tracing a JAX ``init``. The port then loads the JAX tree back through
its bridge (``state_dict_from_jax``), which is what the tests hold it to.
"""

import dataclasses

import jax
import numpy as np
import torch

from aptai_tpu.models.hf_convert import (convert_w2v2_pr,
                                         convert_wav2vec2_encoder)
from aptai_tpu_torch.models.aptai import APTAI
from aptai_tpu_torch.models.convert import (state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.models.w2v2_pr import W2V2PR
from aptai_tpu_torch.models.wav2vec2 import init_weights_

NO_DROP = dict(hidden_dropout=0.0, activation_dropout=0.0,
               attention_dropout=0.0, feat_proj_dropout=0.0)


def _noisy_state_dict(model, seed: int):
    init_weights_(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: v.float().numpy()
            + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in model.state_dict().items()}


def random_jax_aptai_params(cfg_t, num_phonemes: int, seed: int):
    """A JAX ``APTAI`` parameter tree of numpy arrays for the port config
    ``cfg_t``, drawn from ``seed``; under ``fused_qkv`` the same draws as
    without it, q, k and v concatenated by the JAX converter."""
    hf_cfg = dataclasses.replace(cfg_t, fused_qkv=False)  # HF names
    sd = _noisy_state_dict(APTAI(hf_cfg, num_phonemes=num_phonemes), seed)
    enc = convert_wav2vec2_encoder(sd, cfg_t.num_hidden_layers,
                                   prefix="wav2vec2.",
                                   fused_qkv=cfg_t.fused_qkv)
    head = lambda n: {"kernel": sd[f"{n}.weight"].T.copy(),
                      "bias": sd[f"{n}.bias"]}
    return {"encoder": enc, "tv_linear": head("tv_linear"),
            "phn_linear": head("phn_linear")}


def port_aptai_from_jax(cfg_t, params, num_phonemes: int,
                        **kwargs) -> APTAI:
    """The port's APTAI holding the JAX tree ``params`` (through the
    bridge under test), in eval mode on the CPU; ``kwargs`` go to
    :class:`APTAI` (e.g. ``tv_drop``)."""
    model = APTAI(cfg_t, num_phonemes=num_phonemes, **kwargs)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def random_jax_w2v2_pr_params(cfg_t, seed: int):
    """A JAX ``W2V2PR`` parameter tree of numpy arrays for the port config
    ``cfg_t``, drawn from ``seed``."""
    sd = _noisy_state_dict(W2V2PR(cfg_t), seed)
    return convert_w2v2_pr(sd, cfg_t.num_hidden_layers)


def random_jax_force_params(cfg_j, vocab_size: int, seed: int):
    """A JAX ``ForceAPTAI`` parameter tree of numpy arrays for the JAX
    config ``cfg_j``: head leaves of ``init``'s shapes (traced, not run)
    drawn from ``seed``, and the tower of :func:`random_jax_w2v2_pr_params`
    for the matching port config."""
    import functools

    from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
    from aptai_tpu_torch.models.configs import Wav2Vec2Config

    model = JaxForceAPTAI(cfg_j, vocab_size=vocab_size)
    one = np.ones((1,), np.int32)
    shapes = jax.eval_shape(
        functools.partial(model.init, method="train_from_encoded"),
        jax.random.PRNGKey(0), np.zeros((1, 20, cfg_j.hidden_size),
                                        np.float32),
        one * 20, np.zeros((1, 60), np.int32), one, one * 0,
        np.zeros((1, 20, 9), np.float32))["params"]
    rng = np.random.default_rng(seed)
    head = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape))
                        .astype(np.float32), shapes)
    cfg_t = Wav2Vec2Config(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in dataclasses.asdict(cfg_j).items()})
    return dict(head, w2v2_pr=random_jax_w2v2_pr_params(cfg_t, seed + 1))


def port_w2v2_pr_from_jax(cfg_t, params, **kwargs) -> W2V2PR:
    """The port's W2V2PR holding the JAX tree ``params`` (through the
    bridge under test), in eval mode on the CPU; ``kwargs`` go to
    :class:`W2V2PR`."""
    model = W2V2PR(cfg_t, **kwargs)
    model.load_state_dict(w2v2_pr_state_dict_from_jax(params), strict=True)
    return model.eval()


def dense_sd(params, names):
    """Flax Dense leaves of ``params`` → torch Linear weights (transposed
    kernels) under the same names."""
    sd = {}
    for n in names:
        sd[f"{n}.weight"] = torch.from_numpy(
            np.asarray(params[n]["kernel"]).T.copy())
        sd[f"{n}.bias"] = torch.from_numpy(np.asarray(params[n]["bias"]))
    return sd


def module_params(params, layer_norms):
    """Flax LayerNorm leaves (``scale``, ``bias``) → torch names, as
    ``{flax name: torch name}``."""
    sd = {}
    for jn, tn in layer_norms.items():
        sd[f"{tn}.weight"] = torch.from_numpy(
            np.asarray(params[jn]["scale"]))
        sd[f"{tn}.bias"] = torch.from_numpy(np.asarray(params[jn]["bias"]))
    return sd


def torch_grads(tree):
    """The ``.grad`` of every tensor in a pytree of leaf tensors, as
    numpy, in the same structure."""
    return jax.tree.map(lambda t: t.grad.numpy(), tree)


def jax_lstm_one_step_a_loop(monkeypatch):
    """The JAX LSTM scan one step a loop iteration (its default unrolls 8):
    the same arithmetic in a loop body an eighth the size, which XLA
    compiles in half the time on the CPU."""
    import importlib

    monkeypatch.setattr(importlib.import_module("aptai_tpu.ops.lstm"),
                        "SCAN_UNROLL", 1)


def one_torch_thread():
    """A generator for a module fixture: torch on one intra-op thread while
    the module runs, restored after. The tiny configs' ops are too small
    to share out, and under the test workers several processes' thread
    pools would wait on one another at every op of the LSTM and CTC
    loops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# a three-layer stack whose mid layers qualify for the fused conv (C 128)
FUSED_WIDE = dict(NO_DROP, conv_dim=(128,) * 3, fused_feature_extractor=True)


def count_fused_plain(monkeypatch):
    """The input shapes of the fused conv's plain version, one a call,
    recorded from here on in the list returned."""
    from aptai_tpu_torch.ops import fused_conv as tfc

    calls = []
    real = tfc.fused_conv_ln_gelu_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tfc, "fused_conv_ln_gelu_plain", counted)
    return calls
