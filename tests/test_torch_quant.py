"""aptai_tpu_torch's dynamic W8A8 int8 inference (``Wav2Vec2Config.quant``
over ``ops/quant.py``) against the JAX package's, on the CPU (the ops
alone are in ``test_torch_quant_ops.py``):

* the tiny encoder in both modes against the JAX encoder with the same
  weights: free, the hidden states within ``ENCODER_TOL`` of their norm
  (a code that a tie rounds the other way moves every later activation);
  with each quantized layer given the JAX codes and scales for its input,
  within float32 summation error (1e-4 / 1e-5), the port's own codes one
  step from JAX's at most and at ties only (at most 1 in 1000); the state
  dict equal to the exact model's in keys and shapes; within 0.02 of the
  exact model; q, k and v sharing one quantization of x bit for bit as
  three separate projections;
* ``load_model`` / ``load_predictor(quant=...)`` on experiment directories
  the JAX ``CheckpointManager`` wrote, for each family, against the JAX
  ``load_predictor(quant=...)``;
* a forward that needs a gradient raises, an unknown ``quant`` raises, and
  a serving copy keeps the quantized layers' weights in float32.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aptai_tpu.ops.quant as jquant
from aptai_tpu.infer import loader as jloader
from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu_torch.infer import APTAIPredictor
from aptai_tpu_torch.infer.loader import load_model, load_predictor
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.ops import quant as tquant

from _torch_port import (NO_DROP, jax_lstm_one_step_a_loop, one_torch_thread,
                         port_aptai_from_jax, random_jax_aptai_params,
                         random_jax_force_params, random_jax_w2v2_pr_params)


# one code a tie flips changes a product by one step of its row's scale,
# and every later activation with it: the tiny encoder's hidden states
# move by ≈ 1e-3 of their norm for a few flips (by ≈ 1e-6 for none)
ENCODER_TOL = 1e-2
MAX_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


# -- the tiny encoder ---------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_case():
    cfg = tcfg.tiny_config(**NO_DROP)
    params = random_jax_aptai_params(cfg, num_phonemes=11, seed=2)
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    audio[1, 2500:] = 0.0
    lens = np.array([4000, 2500], np.int32)
    return cfg, params, audio, lens


def _port_hidden(model, audio, lens):
    with torch.no_grad():
        return model(torch.from_numpy(audio), torch.from_numpy(lens))[0]


def _jax_rows(mode, params, audio, lens, monkeypatch):
    """The JAX encoder's hidden states under jit, and the quantization of
    each quantized layer's input in the port's call order, as the port's
    ``QuantizedRows`` ((B, T, K) codes, (B, T, 1) scales; q, k and v
    quantize x once)."""
    recs = []
    quantize = jquant.dynamic_quantize

    def recording(x, axes):
        q, s = quantize(x, axes)
        if axes not in (0, (0, 1)):  # an activation, not a weight
            jax.debug.callback(lambda c, sc: recs.append(
                (np.asarray(c), np.asarray(sc))), q, s, ordered=True)
        return q, s

    monkeypatch.setattr(jquant, "dynamic_quantize", recording)
    enc = jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**NO_DROP, quant=mode))
    h = jax.jit(enc.apply)({"params": params["encoder"]},
                           jnp.asarray(audio), jnp.asarray(lens))[0]
    h = np.asarray(h)
    if mode == "w8a8":  # per layer: x for q, k, v; ctx (B, H, T, D); FFN x2
        rows = []
        for i in range(0, len(recs), 6):
            assert all(np.array_equal(recs[i][0], recs[i + j][0])
                       for j in (1, 2))
            c, sc = recs[i + 3]
            b, _, t, _ = c.shape
            rows += [recs[i], (c.transpose(0, 2, 1, 3).reshape(b, t, -1),
                               sc.reshape(b, t, 1)), recs[i + 4],
                     recs[i + 5]]
        recs = rows
    return h, [tquant.QuantizedRows(torch.tensor(c), torch.tensor(sc))
               for c, sc in recs]


@pytest.mark.parametrize("mode", ["w8a8_ffn", "w8a8"])
def test_quantized_encoder_matches_jax(encoder_case, mode, monkeypatch):
    """Free, the port's hidden states within ``ENCODER_TOL`` of the JAX
    encoder's (a code that a tie rounds the other way moves the later
    activations by far more than float32 rounding); with each quantized
    layer given the JAX codes and scales for its input, within float32
    summation error, the port's own codes one step from JAX's at most and
    at ties only."""
    cfg, params, audio, lens = encoder_case
    want, jrows = _jax_rows(mode, params, audio, lens, monkeypatch)
    exact = port_aptai_from_jax(cfg, params, 11).wav2vec2
    model = port_aptai_from_jax(dataclasses.replace(cfg, quant=mode), params,
                                11).wav2vec2
    quant_layers = [m for m in model.modules()
                    if isinstance(m, tw2v.QuantLinear)]
    assert len(quant_layers) == cfg.num_hidden_layers * (
        6 if mode == "w8a8" else 2)
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in exact.state_dict().items()}
    assert len(jrows) == cfg.num_hidden_layers * (4 if mode == "w8a8" else 2)

    quantize_rows = tw2v.quantize_rows
    own = []

    def run(forced):
        own.clear()

        def hook(x):
            rows = quantize_rows(x)
            own.append(rows.codes)
            return jrows[len(own) - 1] if forced else rows

        monkeypatch.setattr(tw2v, "quantize_rows", hook)
        out = _port_hidden(model, audio, lens).numpy()
        monkeypatch.setattr(tw2v, "quantize_rows", quantize_rows)
        assert len(own) == len(jrows)
        return out

    got = run(forced=False)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= ENCODER_TOL, rel
    h_exact = _port_hidden(exact, audio, lens).numpy()
    assert np.linalg.norm(got - h_exact) / np.linalg.norm(h_exact) < 0.02

    got = run(forced=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    flips = total = 0
    for codes, rows in zip(own, jrows):
        assert codes.shape == rows.codes.shape
        diff = (codes.int() - rows.codes.int()).abs()
        assert int(diff.max()) <= 1
        flips += int((diff != 0).sum())
        total += codes.numel()
    assert flips <= MAX_FLIP_SHARE * total, (flips, total)


def test_attention_shares_one_quantization_of_x(encoder_case):
    """q, k and v read one quantization of x: bit for bit what three
    separate projections give."""
    cfg, params, _, _ = encoder_case
    model = port_aptai_from_jax(dataclasses.replace(cfg, quant="w8a8"),
                                params, 11).wav2vec2
    attn = model.encoder.layers[0].attention
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 13, cfg.hidden_size)).astype(np.float32))
    lengths = torch.tensor([13, 7], dtype=torch.int32)
    from aptai_tpu_torch.ops.attention import multi_head_attention_bhtd

    heads = cfg.num_attention_heads
    with torch.no_grad():
        got = attn(x, lengths)
        q, k, v = (tquant.w8a8_head_proj(x, p.weight, heads)
                   + p.bias.view(heads, 1, -1)
                   for p in (attn.q_proj, attn.k_proj, attn.v_proj))
        ctx = multi_head_attention_bhtd(q, k, v, lengths)
        want = tquant.w8a8_out_proj(ctx, attn.out_proj.weight) \
            + attn.out_proj.bias
    assert torch.equal(got, want)


# -- the loader over JAX experiment directories -------------------------------

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
VOCAB = {f"p{i}": i for i in range(V)}
FAMILIES = {  # kind: (mode, entry, float outputs, integer outputs)
    "aptai": ("w8a8", "predict_batch", ("tvs_pred", "phn_fc_probs"),
              ("phn_fc_pred",)),
    "w2v2_pr": ("w8a8_ffn", "encode_batch",
                ("phoneme_logits", "last_transf_hidden"), ()),
    "force_aptai": ("w8a8", "predict_batch", ("tvs_pred", "hidden_tvs"),
                    ("pred_ctc_phn_seq", "phn_seq_lengths")),
}


def _shape_only_init(init):
    """A flax ``init`` that traces the model for its parameter shapes and
    returns zeros, where the JAX loader's eager ``init`` would run it op by
    op for the template its checkpoint restores into (≈ 40 s for the three
    tiny families on the CPU; the template's values are never read)."""
    def shapes(self, *args, **kwargs):
        tree = jax.eval_shape(functools.partial(init, self), *args, **kwargs)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    return shapes


@pytest.fixture(scope="module")
def jax_experiments(tmp_path_factory):
    cfg = tcfg.tiny_config(**STACK)
    trees = {"aptai": random_jax_aptai_params(cfg, V, 2),
             "w2v2_pr": random_jax_w2v2_pr_params(
                 dataclasses.replace(cfg, vocab_size=V), 1),
             "force_aptai": random_jax_force_params(
                 jcfg.tiny_config(**STACK), V, 3)}
    root = tmp_path_factory.mktemp("jax_quant_runs")
    for kind, tree in trees.items():
        backbone = jcfg.tiny_config(**STACK)
        if kind == "w2v2_pr":
            backbone = dataclasses.replace(backbone, vocab_size=V)
        model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": VOCAB,
                     "kind": kind}
        if kind == "force_aptai":
            model_cfg.update(decode_method="greedy", pr_spliced=True)
        jckpt.CheckpointManager(root / kind, "m").update(
            0, {"m": 1.0}, tree, model_cfg=model_cfg)
    return root


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_load_predictor_quant_matches_jax(jax_experiments, kind,
                                          monkeypatch):
    mode, entry, close, equal = FAMILIES[kind]
    exp = jax_experiments / kind
    got_kind, model, _ = load_model(exp, quant=mode)
    assert got_kind == kind and model.cfg.quant == mode
    assert any(isinstance(m, tw2v.QuantLinear) for m in model.modules())
    rng = np.random.default_rng(5)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 9_000, 24_000)]
    got = getattr(load_predictor(exp, device="cpu", quant=mode), entry)(wavs)
    monkeypatch.setattr(fnn.Module, "init", _shape_only_init(fnn.Module.init))
    if kind == "force_aptai":
        jax_lstm_one_step_a_loop(monkeypatch)
    jpred = jloader.load_predictor(exp, quant=mode)
    jmodel = jpred.model
    assert (jmodel.pr_cfg if kind == "force_aptai" else jmodel.cfg).quant \
        == mode
    want = getattr(jpred, entry)(wavs)
    for k in close:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= ENCODER_TOL, (k, rel)
    for k in equal:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        # a code flipped at a tie may move an argmax between near-equal
        # logits; the frames must agree but for a few
        assert np.mean(g == w) >= 0.98, k


# -- refusals and the serving copy --------------------------------------------

def test_gradient_and_unknown_mode_raise(encoder_case):
    cfg, params, audio, lens = encoder_case
    with pytest.raises(ValueError, match="quant must be one of"):
        tcfg.tiny_config(quant="int4")
    model = port_aptai_from_jax(dataclasses.replace(cfg, quant="w8a8_ffn"),
                                params, 11).wav2vec2
    with pytest.raises(NotImplementedError, match="inference only"):
        model(torch.from_numpy(audio), torch.from_numpy(lens))
    layer = model.encoder.layers[0].feed_forward.intermediate_dense
    layer.requires_grad_(False)
    x = torch.ones(1, 3, cfg.hidden_size, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        layer(x)
    with torch.no_grad():
        assert layer(x).shape == (1, 3, cfg.intermediate_size)


def test_serving_copy_keeps_quantized_weights_float32():
    model = random_aptai(tcfg.tiny_config(dtype="bfloat16", quant="w8a8_ffn"),
                         seed=4, num_phonemes=11)
    serving = APTAIPredictor(model, device="cpu").model
    layers = serving.wav2vec2.encoder.layers
    for layer in layers:
        for lin in (layer.feed_forward.intermediate_dense,
                    layer.feed_forward.output_dense):
            assert lin.weight.dtype == lin.bias.dtype == torch.float32
        assert layer.attention.q_proj.weight.dtype == torch.bfloat16
    lin = layers[0].feed_forward.intermediate_dense
    codes = lin.weight_codes()
    assert lin.weight_codes() is codes  # cached while the weight is unchanged
    with torch.no_grad():
        lin.weight.mul_(2.0)
    assert lin.weight_codes() is not codes
    assert torch.equal(lin.weight_codes().codes, codes.codes)
