"""aptai_tpu_torch fused conv + LayerNorm + GELU against the JAX package:
the port's plain version against the Pallas kernel (interpret mode), the
encoder with ``fused_feature_extractor`` on against the JAX encoder (its
XLA path in float32, its Pallas path in bf16), the gate, the exact GELU and
the refusal to run where a gradient is required."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.ops.fused_conv import fused_conv_ln_gelu as jax_fused
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_w2v2_pr
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.ops import fused_conv as tfc

from _torch_port import NO_DROP, port_aptai_from_jax, random_jax_aptai_params

WIDE = dict(NO_DROP, conv_dim=(128,) * 3, fused_feature_extractor=True)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |a|: with
    |a| = m·2^e, m in [0.5, 1), it is 2^(e − 8)."""
    _, exp = np.frexp(np.maximum(np.abs(a.astype(np.float64)), 1e-30))
    return np.ldexp(1.0, exp - 8)


def _operands(rng, b, length, c, k, bias):
    x = rng.standard_normal((b, length, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, c)) / np.sqrt(k * c)).astype(np.float32)
    bb = rng.standard_normal(c).astype(np.float32) if bias else None
    ls = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w, bb, ls, lb


U32 = 2.0 ** -24  # float32 unit roundoff
GELU_PRIME_MAX = 1.13  # max of d/dy 0.5·y·(1 + erf(y/√2)), at y = √2
# absolute error of an f32 erf: the TPU kernel's Abramowitz-Stegun
# polynomial (1.5e-7) plus its f32 evaluation; torch's is within an ulp
ERF_ABS_ERR = 1.5e-7 + 8 * U32


def _float32_error_bound(x, w, bb, ls, lb, stride, eps=1e-5):
    """The function evaluated in float64 from the float32 operands (x
    (B, L, C), w (k, C_in, C_out), the JAX kernel's layout), and a
    per-element bound on the error of ANY float32 evaluation of it: the
    forward-error bound γ_n·Σ|x·w| of the (k·C_in + 1)-term dot (bias
    included), whatever its summation order, carried through the mean, the
    two-pass variance, rsqrt (a few ulps), the affine and GELU (its slope
    is at most GELU_PRIME_MAX; erf within ERF_ABS_ERR). Returns (exact,
    bound)."""
    def gamma(m):
        return m * U32 / (1 - m * U32)

    x, w = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    bsz, length, c = x.shape
    k, _, c_out = w.shape
    t_out = (length - k) // stride + 1
    patches = x.as_strided((bsz, t_out, k * c), (length * c, stride * c, 1))
    wk = w.reshape(k * c, -1)
    acc, mag = patches @ wk, patches.abs() @ wk.abs()
    if bb is not None:
        acc = acc + torch.from_numpy(bb).double()
        mag = mag + torch.from_numpy(bb).double().abs()
    e_acc = gamma(k * c + 1) * mag
    mean = acc.mean(-1, keepdim=True)
    e_mean = (e_acc.mean(-1, keepdim=True)
              + gamma(c_out) * acc.abs().mean(-1, keepdim=True)
              + U32 * mean.abs())
    d = acc - mean
    e_d = e_acc + e_mean + U32 * (d.abs() + e_acc + e_mean)
    var = (d ** 2).mean(-1, keepdim=True)
    e_var = ((2 * d.abs() * e_d + e_d ** 2).mean(-1, keepdim=True)
             + gamma(c_out + 1) * ((d.abs() + e_d) ** 2).mean(-1,
                                                              keepdim=True))
    rel_var = e_var / (var + eps)
    rstd = torch.rsqrt(var + eps)
    e_rstd = rstd * (0.5 * rel_var / (1 - rel_var) + 6 * U32)
    ls, lb = torch.from_numpy(ls).double(), torch.from_numpy(lb).double()
    y = d * rstd * ls + lb
    e_y = (ls.abs() * (e_d * rstd + (d.abs() + e_d) * e_rstd)
           + gamma(3) * ((d * rstd * ls).abs() + lb.abs()))
    out = 0.5 * y * (1.0 + torch.erf(y * 2.0 ** -0.5))
    bound = (GELU_PRIME_MAX * e_y + 0.5 * (y.abs() + e_y) * ERF_ABS_ERR
             + 4 * U32 * out.abs())
    return out.numpy(), bound.numpy()


@pytest.mark.parametrize("k,length,bias", [
    (3, 2 * 1100 + 1, True),   # T_out 1100: crosses the 1024-row cell
    (2, 2 * 1030 + 1, True),   # T_out 1030, a ragged tail past one cell
    (3, 700, False),           # one partial cell, no bias
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(k, length, bias, dtype):
    rng = np.random.default_rng(k * 1000 + length)
    x, w, bb, ls, lb = _operands(rng, 2, length, 128, k, bias)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_fused(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     None if bb is None else jnp.asarray(bb, jdt),
                     jnp.asarray(ls), jnp.asarray(lb), 2, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    # the same values in the port: x, w, b in the compute dtype, LN f32
    tx = torch.from_numpy(x).to(tdt)
    tw = tfc.kernel_weight(torch.from_numpy(w).permute(2, 1, 0).to(tdt))
    tb = None if bb is None else torch.from_numpy(bb).to(tdt)
    got = tfc.fused_conv_ln_gelu_plain(tx, tw, tb, torch.from_numpy(ls),
                                       torch.from_numpy(lb), 2)
    assert got.dtype == tdt and got.shape == want.shape
    assert got.shape[1] == (length - k) // 2 + 1
    got = got.float().numpy()
    if dtype == "float32":
        # each one against the exact value within the error any float32
        # evaluation may have (a fixed 1e-5·max(1, |y|) left no room for
        # the orders and kernels another CPU's libraries pick)
        exact, bound = _float32_error_bound(x, w, bb, ls, lb, 2)
        for name, out in (("plain", got), ("pallas", want)):
            ratio = np.abs(out - exact) / bound
            assert (ratio <= 1).all(), (name, float(ratio.max()))
        # ... and the bound still catches real faults: a tap shifted by one
        # row, and operands rounded to bf16 (a reduced-precision matmul)
        def plain(xx, ww):
            return tfc.fused_conv_ln_gelu_plain(
                torch.from_numpy(xx), tfc.kernel_weight(
                    torch.from_numpy(ww).permute(2, 1, 0)),
                None if bb is None else torch.from_numpy(bb),
                torch.from_numpy(ls), torch.from_numpy(lb), 2).numpy()

        def to_bf16(a):
            return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

        for fault in (plain(np.roll(x, 1, axis=1), w),
                      plain(to_bf16(x), to_bf16(w))):
            assert (np.abs(fault - exact) / bound).max() > 4
    else:
        # a rounding boundary may fall on either side: one bf16 ulp; plus
        # 1e-6 where GELU is tiny (y ≲ −4), where the polynomial erf's
        # 1.5e-7 absolute error times |y|/2 is many ulps of the output
        err = np.abs(got - want)
        assert (err <= bf16_ulp(want) + 1e-6).all(), float(
            (err / bf16_ulp(want)).max())


def test_kernel_weight_layout():
    """The kernel's (C_out, k, C_in) weight from the HF (C_out, C_in, k)
    one: the plain version equals conv1d → LayerNorm → exact GELU."""
    rng = np.random.default_rng(0)
    x, w, bb, ls, lb = _operands(rng, 2, 301, 128, 3, True)
    hf = torch.from_numpy(w).permute(2, 1, 0).contiguous()  # (Cout, Cin, k)
    got = tfc.fused_conv_ln_gelu_plain(
        torch.from_numpy(x), tfc.kernel_weight(hf), torch.from_numpy(bb),
        torch.from_numpy(ls), torch.from_numpy(lb), 2)
    conv = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2),
                                      hf, torch.from_numpy(bb), stride=2)
    want = torch.nn.functional.gelu(torch.nn.functional.layer_norm(
        conv.transpose(1, 2), (128,), torch.from_numpy(ls),
        torch.from_numpy(lb)))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _pair(dtype: str):
    # 16 positional-conv groups (2 channels each): PyTorch's CPU bf16
    # grouped conv1d is wrong at the tiny config's 4 groups of 8 channels
    # (relative error ~1 against float32 on bf16 inputs)
    kw = dict(WIDE, dtype=dtype, num_conv_pos_embedding_groups=16)
    cfg_t = tcfg.tiny_config(**kw)
    params = random_jax_aptai_params(cfg_t, num_phonemes=11, seed=4)
    model = port_aptai_from_jax(cfg_t, params, num_phonemes=11).wav2vec2
    rng = np.random.default_rng(5)
    audio = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    audio[1, 2700:] = 0.0
    lens = np.array([4000, 2700], np.int32)
    enc = jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**kw))
    return enc, params["encoder"], model, audio, lens


def _count_plain(monkeypatch):
    calls = []
    real = tfc.fused_conv_ln_gelu_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tfc, "fused_conv_ln_gelu_plain", counted)
    return calls


def test_encoder_fused_f32_matches_jax(monkeypatch):
    """float32: the JAX CPU encoder takes its XLA conv path (its gate needs
    a TPU), whose function the fused op computes."""
    enc, params, model, audio, lens = _pair("float32")
    calls = _count_plain(monkeypatch)
    with torch.no_grad():
        got_h, got_fl, got_f = model(torch.from_numpy(audio),
                                     torch.from_numpy(lens))
    assert len(calls) == 2  # layers 1 and 2; layer 0 (k10 s5) is not fused
    want_h, want_fl, want_f = jax.jit(enc.apply)(
        {"params": params}, jnp.asarray(audio), jnp.asarray(lens))
    np.testing.assert_array_equal(got_fl.numpy(), np.asarray(want_fl))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-4)


def test_encoder_fused_bf16_matches_jax_pallas(monkeypatch):
    """bf16: the JAX encoder on its fused path, its gate's TPU check
    dropped and the Pallas kernel in interpret mode."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call  # the JAX op passes interpret=False itself
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(
        jw2v, "_fused_fe_applicable",
        lambda cfg, k, s, c: tw2v._fused_fe_applicable(cfg, k, s, c))
    enc, params, model, audio, lens = _pair("bfloat16")
    want_h, _, want_f = jax.jit(enc.apply)(
        {"params": params}, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        got_h, _, got_f = model(torch.from_numpy(audio),
                                torch.from_numpy(lens))
    assert got_f.dtype == torch.bfloat16

    def rel_l2(got, want):
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    # layer 0 is unfused in both, and bf16 rounds at other points in the
    # two frameworks (its conv accumulation, its tanh GELU, and the
    # transformer after the extractor); the fused layers carry those
    # ulps. With the flag off the same pair measures 0.8 % (features) and
    # 1.1 % (hidden states): the bounds leave twice that.
    assert rel_l2(got_f, want_f) <= 0.02
    assert rel_l2(got_h, want_h) <= 0.03


@pytest.mark.parametrize("gelu,dtype", [("auto", "bfloat16"),
                                        ("tanh", "float32")])
def test_fused_layer_uses_exact_gelu(gelu, dtype):
    """The fused op's GELU is exact erf whatever ``cfg.gelu`` says (the TPU
    kernel's); the unfused layer follows ``cfg.gelu``."""
    cfg = tcfg.tiny_config(**WIDE, gelu=gelu, dtype=dtype)
    block = random_w2v2_pr(cfg, seed=0).wav2vec2.feature_extractor \
        .conv_layers[1]
    assert block.fused
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 401, 128)).astype(np.float32)).to(tdt)
    with torch.no_grad():
        got = block.forward_channels_last(x)
        conv = torch.nn.functional.conv1d(
            x.transpose(1, 2).float(), block.conv.weight.to(tdt).float(),
            block.conv.bias.to(tdt).float(), stride=2).transpose(1, 2)
        y = torch.nn.functional.layer_norm(conv, (128,),
                                           block.layer_norm.weight,
                                           block.layer_norm.bias)
        exact = torch.nn.functional.gelu(y).to(tdt)
        tanh = torch.nn.functional.gelu(y, approximate="tanh").to(tdt)
        block.fused = False
        unfused = block.forward_channels_last(x)
    # the same function: within one ulp of the output dtype
    tol = (bf16_ulp(exact.float().numpy()) if dtype == "bfloat16"
           else 1e-5)
    assert (np.abs(got.float().numpy() - exact.float().numpy())
            <= tol).all()
    assert not torch.equal(got, tanh)
    if gelu == "tanh":
        assert (unfused.float() - tanh.float()).abs().max() <= 1e-5
        assert (got - unfused).abs().max() > 1e-4


def test_fused_gate(monkeypatch):
    cfg = tcfg.Wav2Vec2Config(fused_feature_extractor=True)
    layers = tw2v.FeatureExtractor(cfg).conv_layers
    assert [b.fused for b in layers] == [False] + [True] * 6
    ten = tw2v.FeatureExtractor(cfg.with_ten_ms()).conv_layers
    assert [b.fused for b in ten] == [False] + [True] * 5 + [False]
    off = tw2v.FeatureExtractor(tcfg.Wav2Vec2Config()).conv_layers
    assert not any(b.fused for b in off)
    # the JAX gate's terms, its TPU check aside
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for flag in (False, True):
        for norm in ("layer", "group"):
            kw = dict(fused_feature_extractor=flag, feat_extract_norm=norm)
            tc, jc = tcfg.Wav2Vec2Config(**kw), jcfg.Wav2Vec2Config(**kw)
            for k, s, c in ((3, 2, 512), (2, 2, 128), (10, 5, 1), (3, 2, 16),
                            (4, 2, 512), (2, 1, 512), (3, 2, 384)):
                assert (tw2v._fused_fe_applicable(tc, k, s, c)
                        == jw2v._fused_fe_applicable(jc, k, s, c)), (kw, k,
                                                                     s, c)


def test_fused_path_refuses_gradients():
    """No backward exists: a trainable feature encoder raises in a forward
    that needs its gradient; a frozen one runs the fused op without one."""
    cfg = tcfg.tiny_config(**WIDE)
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3000)).astype(np.float32))
    lens = torch.tensor([3000, 2000], dtype=torch.int32)
    labels = torch.tensor([[1, 2, 3], [4, 5, -100]])
    model = random_w2v2_pr(cfg, seed=0).train()
    with pytest.raises(NotImplementedError, match="no backward"):
        model(audio, lens, labels)
    with torch.no_grad():  # no gradient needed: runs
        assert torch.isfinite(model.eval()(audio, lens, labels)["loss"])
    frozen = random_w2v2_pr(cfg, seed=0, freeze_feature_encoder=True)
    out = frozen.train()(audio, lens, labels)
    out["loss"].backward()
    fe = frozen.wav2vec2.feature_extractor
    assert all(p.grad is None for p in fe.parameters())
    assert frozen.pr_head.weight.grad is not None
    x = torch.zeros((1, 9, 128), requires_grad=True)
    w = torch.zeros((128, 3, 128))
    ones, zeros = torch.ones(128), torch.zeros(128)
    with pytest.raises(NotImplementedError, match="no backward"):
        tfc.fused_conv_ln_gelu(x, w, None, ones, zeros, 2)


def test_kernel_weights_follow_parameter_changes():
    """The kernel-layout weight is made once and remade when the conv's
    parameters change in place or move to another dtype."""
    cfg = tcfg.tiny_config(**WIDE)
    block = random_w2v2_pr(cfg, seed=0).wav2vec2.feature_extractor \
        .conv_layers[1]
    x = torch.randn(1, 41, 128)
    with torch.no_grad():
        w1, _ = block._kernel_weights(torch.float32)
        assert block._kernel_weights(torch.float32)[0] is w1
        before = block.forward_channels_last(x)
        block.conv.weight.mul_(2.0)
        w2, _ = block._kernel_weights(torch.float32)
        assert w2 is not w1
        torch.testing.assert_close(w2, tfc.kernel_weight(block.conv.weight))
        assert not torch.equal(block.forward_channels_last(x), before)
        wb, bb = block._kernel_weights(torch.bfloat16)
        assert wb.dtype == bb.dtype == torch.bfloat16


def test_fused_dispatch_by_device(monkeypatch):
    x = torch.zeros((1, 9, 128))
    w = torch.zeros((128, 3, 128))
    ones, zeros = torch.ones(128), torch.zeros(128)
    calls = _count_plain(monkeypatch)
    before = tfc.fused_conv_ln_gelu_cuda.launches
    out = tfc.fused_conv_ln_gelu(x, w, None, ones, zeros, 2)
    assert out.shape == (1, 4, 128) and len(calls) == 1
    assert tfc.fused_conv_ln_gelu_cuda.launches == before
    with pytest.raises(ValueError, match="no fused conv implementation"):
        meta = torch.empty((1, 9, 128), device="meta")
        tfc.fused_conv_ln_gelu(meta, w.to("meta"), None, ones, zeros, 2)
    # the kernel's wrapper refuses a CPU tensor before it builds anything
    with pytest.raises(ValueError, match="CUDA device"):
        tfc.fused_conv_ln_gelu_cuda(x, w, None, ones, zeros, 2)


def _wrapper_case(case):
    """CPU operands for the kernel wrapper, valid but for ``case``."""
    bf16 = torch.bfloat16
    dt = torch.float32 if case in ("f32 C_in", "f32 stride 5") else bf16
    c_in = {"C_in 96": 96, "f32 C_in": 24}.get(case, 128)
    c_out = 192 if case == "C_out 192" else 128
    length = 2 if case == "no rows" else 33
    x = torch.zeros((2, length, c_in), dtype=dt)
    w = torch.zeros((c_out, 3, c_in),
                    dtype=torch.float32 if case == "w dtype" else dt)
    ln_w = torch.ones(c_out, dtype=bf16 if case == "ln dtype" else
                      torch.float32)
    ln_b = torch.zeros(c_out)
    if case == "x strided":
        x = torch.zeros((2, c_in, length), dtype=dt).transpose(1, 2)
    if case == "x misaligned":
        x = torch.zeros(x.numel() + 1, dtype=dt)[1:].view(x.shape)
    stride = 5 if case in ("stride 5", "f32 stride 5") else 2
    return x, w, None, ln_w, ln_b, stride


@pytest.mark.parametrize("case,error,match", [
    ("C_in 96", ValueError, "multiple of 64"),
    ("f32 C_in", ValueError, "multiple of 16"),
    ("C_out 192", ValueError, "built for C_out"),
    ("stride 5", ValueError, "strides up to 4"),
    ("w dtype", TypeError, "same dtype"),
    ("ln dtype", TypeError, "float32"),
    ("no rows", ValueError, "no output rows"),
    ("x strided", ValueError, "contiguous"),
    ("x misaligned", ValueError, "16-byte"),
    # the float32 variant takes any stride; then only the device is wrong
    ("f32 stride 5", ValueError, "CUDA device"),
    ("valid", ValueError, "CUDA device"),
])
def test_kernel_wrapper_refuses(case, error, match):
    """The wrapper checks dtypes, shapes, widths, stride and layout before
    the device, so each refusal the kernel needs is reached on the CPU."""
    before = tfc.fused_conv_ln_gelu_cuda.launches
    with pytest.raises(error, match=match):
        tfc.fused_conv_ln_gelu_cuda(*_wrapper_case(case))
    assert tfc.fused_conv_ln_gelu_cuda.launches == before
