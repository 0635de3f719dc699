"""The encoder's three config variants against the JAX package, on the CPU:
``fused_qkv=True`` (one ``qkv_proj`` Linear, q, k and v as views of its
output), ``attention_layout="bthd"`` and ``do_stable_layer_norm=False``
(the encoder's LayerNorm after the positional conv, in float32).

* each variant and all three together, float32: every
  ``output_hidden_states`` entry and the frame lengths against the jitted
  JAX encoder (one program for the four), rtol 1e-4 / atol 1e-5, the
  weights carried by ``encoder_state_dict_from_jax`` (its ``qkv_proj``
  branch for ``fused_qkv``); ``fused_qkv`` also against JAX's Pallas flash
  path in interpret mode;
* ``do_stable_layer_norm=False`` in bfloat16: the output and every hidden
  state float32 in both packages, within :data:`BF16_REL` of JAX's;
* an HF-named state dict loaded into a ``fused_qkv`` encoder
  (``train/builders.py::_load_hf_encoder``) against the JAX encoder that
  ``convert_wav2vec2_encoder(fused_qkv=True)`` builds;
* the split views pass the kernels' stride checks and ``opcheck``;
  an unknown ``attention_layout`` raises; the config dicts cross.

W8A8 and the gradients are in ``test_torch_encoder_variants_train.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.models.hf_convert import convert_wav2vec2_encoder
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.train.builders import _load_hf_encoder

from _torch_port import NO_DROP, one_torch_thread
from _torch_encoder_variants import (VARIANTS, _hf_and_trees, _inputs, _port,
                                     _run_port, _tree)


# bf16 activations in both packages, rounded in other places and orders:
# the default (stable) encoder's hidden states differ by ≈ 1e-2 of their
# norm, as the non-stable one's do
BF16_REL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def f32():
    """Per variant: (port config, JAX tree, the JAX encoder's outputs with
    every hidden state), the four JAX encoders in one jitted program."""
    base = tcfg.tiny_config(**NO_DROP)
    hf, trees = _hf_and_trees(base, seed=2)
    cfgs = {n: dataclasses.replace(base, **kw) for n, kw in VARIANTS.items()}
    encs = {n: jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**NO_DROP, **kw))
            for n, kw in VARIANTS.items()}

    @jax.jit
    def run(trees, audio, lens):
        return {n: enc.apply({"params": _tree(trees, cfgs[n])}, audio, lens,
                             output_hidden_states=True)
                for n, enc in encs.items()}

    audio, lens = _inputs()
    want = jax.tree.map(np.asarray, run(trees, audio, lens))
    cases = {n: (cfgs[n], _tree(trees, cfgs[n]), want[n]) for n in VARIANTS}
    return cases, hf


def _assert_outputs_match(got, want):
    h, fl, feats, hidden = got
    w_h, w_fl, w_feats, w_hidden = want
    np.testing.assert_array_equal(fl.numpy(), w_fl)
    assert len(hidden) == len(w_hidden)
    for i, (g, w) in enumerate(zip(hidden, w_hidden)):
        assert g.dtype == torch.float32 and w.dtype == np.float32, i
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"hidden state {i}")
    np.testing.assert_allclose(feats.numpy(), w_feats, rtol=1e-4, atol=1e-5)
    # entry N is the encoder's output
    assert torch.equal(hidden[-1], h)
    np.testing.assert_allclose(h.numpy(), w_h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax_encoder(f32, name):
    """Every hidden state, pad frames included; entry 0 is the post-
    LayerNorm state under ``do_stable_layer_norm=False``."""
    cases, _ = f32
    cfg, tree, want = cases[name]
    model = _port(cfg, tree)
    assert hasattr(model.encoder.layers[0].attention, "qkv_proj") \
        == cfg.fused_qkv
    _assert_outputs_match(_run_port(model, *_inputs()), want)


def test_bthd_is_the_default_computation(f32):
    """``"bthd"`` runs the default's code on the same parameters: bit for
    bit the same hidden states."""
    cases, _ = f32
    cfg, tree, _ = cases["bthd"]
    got = _run_port(_port(cfg, tree), *_inputs())[3]
    want = _run_port(_port(dataclasses.replace(cfg, attention_layout="bhtd"),
                           tree), *_inputs())[3]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_qkv_matches_jax_flash_path(f32, monkeypatch):
    """The JAX encoder with ``fused_qkv`` on its Pallas flash attention
    (interpret mode), the stack padded to the kernel's 128-frame tiles."""
    from jax.experimental import pallas as pl

    import aptai_tpu.ops.attention as jatt

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jatt, "_use_flash", lambda *a: True)
    monkeypatch.setattr(jw2v, "_stack_pads_to_tiles", lambda *a: True)
    cases, _ = f32
    cfg, tree, _ = cases["fused_qkv"]
    enc = jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**NO_DROP, fused_qkv=True))
    audio, lens = _inputs()
    want = np.asarray(jax.jit(enc.apply)({"params": tree}, audio, lens)[0])
    assert want.shape[1] % 128 != 0, "the stack pad must be exercised"
    got = _run_port(_port(cfg, tree), audio, lens, hidden=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_non_stable_bf16_hidden_states_are_float32():
    """Under ``dtype="bfloat16"`` the non-stable encoder's LayerNorm (no
    ``dtype`` in JAX) promotes the residual stream to float32: the output
    and every hidden state are float32 in both packages, while the
    sublayers take bf16 inputs and the stable default stays bf16. 16
    positional-conv groups: PyTorch's CPU bf16 grouped conv1d is wrong at
    4 groups of 8 channels (ROADMAP Queue 3)."""
    kw = dict(NO_DROP, num_conv_pos_embedding_groups=16, dtype="bfloat16",
              do_stable_layer_norm=False)
    cfg = tcfg.tiny_config(**kw)
    _, trees = _hf_and_trees(cfg, seed=5)
    enc = jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**kw))
    audio, lens = _inputs()
    w_h, _, _, w_hidden = jax.jit(functools.partial(
        enc.apply, output_hidden_states=True))(
        {"params": trees["apart"]}, audio, lens)
    model = _port(cfg, trees["apart"])
    seen = []  # the sublayers' input dtypes: they compute in bf16
    for layer in model.encoder.layers:
        for sub in (layer.attention, layer.feed_forward):
            sub.register_forward_pre_hook(
                lambda m, args: seen.append(args[0].dtype))
    h, _, _, hidden = _run_port(model, audio, lens)
    assert seen == [torch.bfloat16] * (2 * cfg.num_hidden_layers)
    assert w_h.dtype == jnp.float32 and h.dtype == torch.float32
    for i, (g, w) in enumerate(zip(hidden, w_hidden)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32, i
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= BF16_REL, (i, rel)
    stable = _port(dataclasses.replace(cfg, do_stable_layer_norm=True),
                   trees["apart"])
    out = _run_port(stable, audio, lens)
    assert out[0].dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in out[3])


# -- loading ------------------------------------------------------------------

def test_hf_state_dict_loads_into_a_fused_encoder(f32):
    """An HF-named state dict (``pytorch_model.bin``'s ``wav2vec2.``
    names) into a ``fused_qkv`` encoder: q, k and v concatenated, the
    output of the JAX encoder built by
    ``convert_wav2vec2_encoder(fused_qkv=True)``."""
    cases, hf = f32
    cfg, _, want = cases["fused_qkv"]
    sd = {f"wav2vec2.{k}": torch.from_numpy(v) for k, v in hf.items()}
    sd["pr_head.weight"] = torch.zeros(3, cfg.hidden_size)
    model = tw2v.Wav2Vec2Model(cfg).eval()
    _load_hf_encoder(model, sd)
    got = _run_port(model, *_inputs())
    _assert_outputs_match(got, want)


# -- the kernels' inputs, the config ------------------------------------------

def test_split_views_pass_the_kernel_checks():
    """q, k and v split from one (B, T, 3C) product: (B, H, T, 64) views
    with a 3C time stride, which the kernels' stride checks accept (bf16 at
    C 1024, the full width) and the ops' fake implementations describe
    (``opcheck``); their gradients stack into the product's, as the plain
    attention's on contiguous copies do."""
    b, t, h, d = 2, 9, 2, tatt.HEAD_DIM
    c = h * d
    for dtype, width in ((torch.bfloat16, 1024), (torch.float32, c)):
        qkv = torch.zeros(b, t, 3 * width, dtype=dtype)
        for x in qkv.split(width, -1):
            view = x.view(b, t, width // d, d).transpose(1, 2)
            assert tatt._kernel_strides_ok(view), (dtype, view.stride())
            assert view.stride(2) == 3 * width
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * c)).astype(
        np.float32)).requires_grad_()
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(c, -1))
    lens = torch.tensor([t, 5], dtype=torch.int32)
    dout = torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
        np.float32))
    qd, kd, vd = (x.detach() for x in (q, k, v))
    out, lse = tatt.flash_fwd_lse(qd, kd, vd, lens)
    _, delta = tatt.flash_bwd_dq(qd, kd, vd, out, lse, dout, lens)
    for op, args in ((tatt.flash_fwd, (qd, kd, vd, lens)),
                     (tatt.flash_fwd_lse, (qd, kd, vd, lens)),
                     (tatt.flash_bwd_dq, (qd, kd, vd, out, lse, dout, lens)),
                     (tatt.flash_bwd_dkv,
                      (qd, kd, vd, dout, lse, delta, lens))):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, (op, result)

    tatt.multi_head_attention_bhtd(q, k, v, lens).backward(dout)
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = (x.reshape(b, t, h, d).transpose(1, 2).contiguous()
                  for x in ref.split(c, -1))
    tatt.flash_attention_bhtd_plain(rq, rk, rv, lens).backward(dout)
    torch.testing.assert_close(qkv.grad, ref.grad, rtol=1e-5, atol=1e-6)


def test_layouts_and_config_dicts_cross():
    """The variants' config dicts are the JAX package's; an
    ``attention_layout`` other than ``"bhtd"`` / ``"bthd"`` raises (the JAX
    package runs it as ``"bthd"``), and so does an ``activation_partition``
    the port cannot place (the time axis over the data axis); the
    placeable ones cross."""
    for kw in VARIANTS.values():
        assert (dataclasses.asdict(tcfg.tiny_config(**kw))
                == dataclasses.asdict(jcfg.tiny_config(**kw)))
    with pytest.raises(ValueError, match="attention_layout"):
        tcfg.Wav2Vec2Config(attention_layout="bhdt")
    with pytest.raises(ValueError, match="activation_partition"):
        tcfg.Wav2Vec2Config(activation_partition=(None, "data", None))
    for spec in (("data", None, None), ("data", "model", None)):
        assert (dataclasses.asdict(tcfg.tiny_config(activation_partition=spec))
                == dataclasses.asdict(jcfg.tiny_config(
                    activation_partition=spec)))
