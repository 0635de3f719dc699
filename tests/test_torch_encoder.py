"""aptai_tpu_torch config + wav2vec2 encoder against the JAX package:
config fields and defaults, frame-length formula, the weight bridge, and
f32 hidden states (pad frames included) with the JAX encoder on its XLA
attention path and on its Pallas flash path (interpret mode)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.models.hf_convert import export_wav2vec2_encoder
from aptai_tpu_torch.infer import APTAIPredictor
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai
from aptai_tpu_torch.models.convert import encoder_state_dict_from_jax

from _torch_port import NO_DROP, port_aptai_from_jax, random_jax_aptai_params


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.Wav2Vec2Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.Wav2Vec2Config)}
    assert tf == jf
    assert (dataclasses.asdict(tcfg.tiny_config())
            == dataclasses.asdict(jcfg.tiny_config()))
    for j, t in ((jcfg.Wav2Vec2Config(), tcfg.Wav2Vec2Config()),
                 (jcfg.tiny_config(), tcfg.tiny_config())):
        assert t.head_dim == j.head_dim
        assert (dataclasses.asdict(t.with_ten_ms())
                == dataclasses.asdict(j.with_ten_ms()))


@pytest.mark.parametrize("field,value", [
    ("activation_partition", ("data", None, "model")),
])
def test_unported_config_fields_raise(field, value):
    """A value the port cannot place raises a ``ValueError`` naming the
    field (the hidden dimension split over the model axis; the JAX package
    hands any spec to XLA's partitioner)."""
    with pytest.raises(ValueError, match=field):
        tcfg.Wav2Vec2Config(**{field: value})


def test_quant_modes_cross_and_unknown_ones_raise():
    """The W8A8 modes are the JAX package's; an unknown string raises where
    the JAX package would serve it as "none"."""
    for mode in ("none", "w8a8_ffn", "w8a8"):
        assert (dataclasses.asdict(tcfg.tiny_config(quant=mode))
                == dataclasses.asdict(jcfg.tiny_config(quant=mode)))
    with pytest.raises(ValueError, match="quant must be one of"):
        tcfg.Wav2Vec2Config(quant="w8a8_all")


def test_feat_extract_output_lengths_match_jax():
    samples = np.arange(400, 200_000, 997)
    for j, t in ((jcfg.Wav2Vec2Config(), tcfg.Wav2Vec2Config()),
                 (jcfg.tiny_config(), tcfg.tiny_config()),
                 (jcfg.Wav2Vec2Config().with_ten_ms(),
                  tcfg.Wav2Vec2Config().with_ten_ms())):
        want = np.asarray(j.feat_extract_output_lengths(samples))
        np.testing.assert_array_equal(t.feat_extract_output_lengths(samples),
                                      want)
        got_t = t.feat_extract_output_lengths(
            torch.from_numpy(samples.astype(np.int32)))
        np.testing.assert_array_equal(got_t.numpy(), want)
        assert [t.feat_extract_output_lengths(int(s)) for s in samples[:5]] \
            == [int(w) for w in want[:5]]


@pytest.fixture(scope="module")
def pair():
    cfg_j = jcfg.tiny_config(**NO_DROP)
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    audio[1, 2500:] = 0.0
    lens = np.array([4000, 2500], np.int32)
    cfg_t = tcfg.tiny_config(**NO_DROP)
    aptai_params = random_jax_aptai_params(cfg_t, num_phonemes=11, seed=2)
    model = port_aptai_from_jax(cfg_t, aptai_params, num_phonemes=11)
    return (jw2v.Wav2Vec2Encoder(cfg_j), aptai_params["encoder"],
            model.wav2vec2, audio, lens)


def _port(model, audio, lens):
    with torch.no_grad():
        h, fl, feats = model(torch.from_numpy(audio), torch.from_numpy(lens))
    return h.numpy(), fl.numpy(), feats.numpy()


def test_weight_bridge_matches_hf_export(pair):
    _, params, _, _, _ = pair
    want = export_wav2vec2_encoder(params, jcfg.tiny_config().num_hidden_layers)
    got = encoder_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_encoder_hidden_states_match_jax(pair):
    enc, params, model, audio, lens = pair
    want_h, want_fl, want_f = jax.jit(enc.apply)(
        {"params": params}, jnp.asarray(audio), jnp.asarray(lens))
    got_h, got_fl, got_f = _port(model, audio, lens)
    np.testing.assert_array_equal(got_fl, np.asarray(want_fl))
    assert got_fl[1] < got_h.shape[1]  # item 1 has pad frames
    # every frame, pad frames included; the tolerance covers summation order
    np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_h, np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)


def test_encoder_matches_jax_flash_path(pair, monkeypatch):
    """The JAX encoder with its Pallas flash attention forced on (interpret
    mode) and the stack padded to the kernel's 128-frame tiles."""
    from jax.experimental import pallas as pl

    import aptai_tpu.ops.attention as jatt

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jatt, "_use_flash", lambda *a: True)
    monkeypatch.setattr(jw2v, "_stack_pads_to_tiles", lambda *a: True)
    enc, params, model, audio, lens = pair
    want_h, _, _ = jax.jit(enc.apply)({"params": params}, jnp.asarray(audio),
                                      jnp.asarray(lens))
    assert want_h.shape[1] % 128 != 0, "the stack pad must be exercised"
    got_h, _, _ = _port(model, audio, lens)
    np.testing.assert_allclose(got_h, np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)


def test_bf16_policy_casts_matmul_weights_only():
    """The model holds float32 parameters and computes in bf16 (the JAX
    package's policy, so Adam updates float32 masters); the predictor's
    serving copy casts the encoder's Linear and Conv1d parameters, and
    only those, to bf16 once, and computes the same hidden states."""
    model = random_aptai(tcfg.tiny_config(dtype="bfloat16"), seed=0,
                         num_phonemes=11)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    serving = APTAIPredictor(model, device="cpu").model
    for name, p in serving.named_parameters():
        matmul = (name.startswith("wav2vec2.")
                  and name.endswith(("conv.weight", "conv.bias", "proj.weight",
                                     "proj.bias", "projection.weight",
                                     "projection.bias", "dense.weight",
                                     "dense.bias"))
                  and "pos_conv_embed" not in name)
        want = torch.bfloat16 if matmul else torch.float32
        assert p.dtype == want, name
    # the caller's model is left in float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    audio = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 4000)).astype(np.float32))
    lens = torch.tensor([4000, 3000], dtype=torch.int32)
    with torch.no_grad():
        h, _, _ = model.eval().wav2vec2(audio, lens)
        h_serving, _, _ = serving.wav2vec2(audio, lens)
    assert h.dtype == torch.bfloat16 and torch.isfinite(h.float()).all()
    torch.testing.assert_close(h_serving, h, rtol=0, atol=0)


def test_layer_stack_fn_replaces_the_layer_loop(pair):
    """The hook (the pipe axis's seat, ``parallel/pipeline.py``) sits where
    the JAX package's does: an identity hook skips exactly the layers (the
    positional conv before it and the final LayerNorm after it run), and a
    hook that runs the layers is the built-in loop bit for bit."""
    enc, params, model, audio, lens = pair
    a, n = torch.from_numpy(audio), torch.from_numpy(lens)

    def skip(h, frame_lengths):
        return h

    want, _, _ = jax.jit(lambda p: enc.apply(
        {"params": p}, jnp.asarray(audio), jnp.asarray(lens),
        layer_stack_fn=skip))(params)
    with torch.no_grad():
        got, _, _ = model(a, n, layer_stack_fn=skip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

        def loop(h, frame_lengths):
            for layer in model.encoder.layers:
                h = layer(h, frame_lengths)
            return h

        hooked, _, _ = model(a, n, layer_stack_fn=loop)
        plain, _, _ = model(a, n)
    torch.testing.assert_close(hooked, plain, rtol=0, atol=0)


def test_layer_stack_fn_refuses_hidden_states(pair):
    """With ``output_hidden_states`` the hook raises the JAX package's
    ``ValueError``."""
    enc, params, model, audio, lens = pair

    def skip(h, frame_lengths):
        return h

    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda p: enc.apply(
            {"params": p}, jnp.asarray(audio), jnp.asarray(lens),
            output_hidden_states=True, layer_stack_fn=skip), params)
    with pytest.raises(ValueError) as got:
        model(torch.from_numpy(audio), torch.from_numpy(lens),
              output_hidden_states=True, layer_stack_fn=skip)
    assert str(got.value) == str(want.value)
