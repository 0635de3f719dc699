"""The encoder's config variants against the JAX package, on the CPU, under
W8A8 and in training:

* W8A8 under ``"bthd"`` and ``fused_qkv``: the quantized Linears are the
  JAX package's (the FFN's two a layer), the hidden states within
  ``ENCODER_TOL`` free and within float32 summation error given JAX's
  codes (``tests/test_torch_quant.py``'s method);
* the APTAI loss and every parameter gradient (``qkv_proj``'s included)
  against ``jax.grad`` for ``fused_qkv`` + non-stable.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import aptai_tpu.ops.quant as jquant
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.models.convert import state_dict_from_jax
from aptai_tpu_torch.ops import quant as tquant

from _torch_port import (NO_DROP, one_torch_thread, port_aptai_from_jax,
                         random_jax_aptai_params)
from _torch_encoder_variants import (NUM_PHN, _hf_and_trees, _inputs, _layout,
                                     _port, _run_port, _tree)


# tests/test_torch_quant.py: a code that a tie rounds the other way moves
# every later activation
ENCODER_TOL = 1e-2
MAX_FLIP_SHARE = 1e-3
QUANT_CASES = [(layout, mode) for layout in ("bthd", "fused_qkv")
               for mode in ("w8a8_ffn", "w8a8")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


# -- W8A8 ---------------------------------------------------------------------

def _jax_path_to_port(path):
    """A flax module path inside the encoder → the port's module name."""
    first, *rest = path
    if first.startswith("layers_"):
        first = f"encoder.layers.{first.split('_')[1]}"
    return ".".join([first, *rest])


@pytest.fixture(scope="module")
def quant_refs():
    """Per (layout, mode): the JAX encoder's output, the names of the
    layers it quantizes (module paths seen while tracing), and the codes
    and scales of each quantized layer's input in call order; the four in
    one jitted program."""
    cfg = tcfg.tiny_config(**NO_DROP)
    _, trees = _hf_and_trees(cfg, seed=2)
    encs = {c: jw2v.Wav2Vec2Encoder(jcfg.tiny_config(
        **NO_DROP, quant=c[1], **_layout(c[0]))) for c in QUANT_CASES}
    rows = {c: [] for c in QUANT_CASES}
    quantized = {c: set() for c in QUANT_CASES}
    tracing = [None]
    quantize = jquant.dynamic_quantize

    def recording(x, axes):
        q, s = quantize(x, axes)
        if axes not in (0, (0, 1)):  # an activation, not a weight
            jax.debug.callback(functools.partial(
                lambda key, c, sc: rows[key].append(
                    (np.asarray(c), np.asarray(sc))), tracing[0]),
                q, s, ordered=True)
        return q, s

    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if context.method_name == "__call__" and (
                isinstance(m, jw2v.QuantDense)
                or getattr(m, "quant", False) is True):
            quantized[tracing[0]].add(_jax_path_to_port(m.path))
        return next_fun(*args, **kwargs)

    @jax.jit
    def run(trees, audio, lens):
        out = {}
        for c, enc in encs.items():
            tracing[0] = c
            with fnn.intercept_methods(interceptor):
                out[c] = enc.apply({"params": trees[
                    "fused" if c[0] == "fused_qkv" else "apart"]},
                    audio, lens)[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "dynamic_quantize", recording)
        want = jax.tree.map(np.asarray, run(trees, *_inputs()))
    return cfg, trees, {c: (want[c], quantized[c], [
        tquant.QuantizedRows(torch.tensor(c_), torch.tensor(s_))
        for c_, s_ in rows[c]]) for c in QUANT_CASES}


@pytest.mark.parametrize("case", QUANT_CASES, ids="-".join)
def test_w8a8_quantizes_the_jax_layers(quant_refs, case, monkeypatch):
    """With ``"bthd"`` or ``fused_qkv`` the JAX package quantizes the FFN
    only, under ``"w8a8"`` as under ``"w8a8_ffn"``; the hidden states
    under ``tests/test_torch_quant.py``'s gates."""
    layout, mode = case
    base, trees, refs = quant_refs
    want, jax_layers, jrows = refs[case]
    cfg = dataclasses.replace(base, quant=mode, **_layout(layout))
    model = _port(cfg, _tree(trees, cfg))
    layers = {n for n, m in model.named_modules()
              if isinstance(m, tw2v.QuantLinear)}
    assert layers == jax_layers
    assert layers == {f"encoder.layers.{i}.feed_forward.{d}"
                      for i in range(cfg.num_hidden_layers)
                      for d in ("intermediate_dense", "output_dense")}
    assert len(jrows) == len(layers)

    quantize_rows = tw2v.quantize_rows
    own = []

    def run(forced):
        own.clear()

        def hook(x):
            rows = quantize_rows(x)
            own.append(rows.codes)
            return jrows[len(own) - 1] if forced else rows

        monkeypatch.setattr(tw2v, "quantize_rows", hook)
        out = _run_port(model, *_inputs(), hidden=False)[0].numpy()
        monkeypatch.setattr(tw2v, "quantize_rows", quantize_rows)
        assert len(own) == len(jrows)
        return out

    got = run(forced=False)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= ENCODER_TOL, rel
    got = run(forced=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    flips = total = 0
    for codes, rows in zip(own, jrows):
        diff = (codes.int() - rows.codes.int()).abs()
        assert int(diff.max()) <= 1
        flips += int((diff != 0).sum())
        total += codes.numel()
    assert flips <= MAX_FLIP_SHARE * total, (flips, total)


# -- training -----------------------------------------------------------------

def test_gradients_match_jax_grad():
    """``fused_qkv`` + non-stable, float32, train mode with dropout and
    masking off: the APTAI loss and the gradient of every trainable
    parameter (the frozen feature encoder gets none) through the bridge,
    1e-3 relative + 1e-5 absolute per tensor."""
    kw = dict(NO_DROP, mask_time_prob=0.0, fused_qkv=True,
              do_stable_layer_norm=False)
    cfg = tcfg.tiny_config(**kw)
    params = random_jax_aptai_params(cfg, NUM_PHN, seed=11)
    heads_off = dict(tv_drop=0.0, phn_drop=0.0)
    jmodel = JaxAPTAI(jcfg.tiny_config(**kw), num_phonemes=NUM_PHN,
                      **heads_off)
    rng = np.random.default_rng(12)
    audio = (rng.standard_normal((2, 2400)) * 0.1).astype(np.float32)
    lens = np.array([2400, 1700], np.int32)
    audio[1, 1700:] = 0.0
    t = int(cfg.feat_extract_output_lengths(2400))
    phn = rng.integers(1, NUM_PHN, (2, t)).astype(np.int32)
    tv = rng.standard_normal((2, t, 9)).astype(np.float32)
    for i, n in enumerate(cfg.feat_extract_output_lengths(lens)):
        phn[i, n:] = 0
        tv[i, n:] = -100.0

    def loss_fn(p):
        return jmodel.apply({"params": p}, audio, lens, phn, tv,
                            deterministic=False)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = port_aptai_from_jax(cfg, params, NUM_PHN, **heads_off).train()
    out = model(*(torch.from_numpy(a) for a in (audio, lens, phn, tv)))
    out["loss"].backward()
    assert out["loss"].item() == pytest.approx(float(jloss), rel=1e-3,
                                               abs=1e-5)
    checked = set()
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert name.startswith("wav2vec2.feature_extractor.") \
                or name.endswith("masked_spec_embed"), name
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        checked.add(name)
    assert {f"wav2vec2.encoder.layers.{i}.attention.qkv_proj.{leaf}"
            for i in range(cfg.num_hidden_layers)
            for leaf in ("weight", "bias")} <= checked
    assert "wav2vec2.encoder.layer_norm.weight" in checked
