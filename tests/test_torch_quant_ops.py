"""aptai_tpu_torch's dynamic W8A8 int8 ops (``ops/quant.py``) against the
JAX package's, on the CPU:

* each op against the jitted JAX function (as the model runs it) on seeded
  inputs, float32 and bfloat16, K 1024 / N 4096 among the shapes and a
  padded row count ≤ 16: codes, scales and outputs equal bit for bit; the
  int8 product against its exact float64 version; widths that are not
  multiples of 8 raise;
* the pins of ``tests/test_quant.py`` on the port: exact on the int8 grid,
  zero rows stay zero, the Gaussian bound, the round-trip bound, the head
  and output layouts against the plain product.

The quantized models are in ``test_torch_quant.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aptai_tpu.ops.quant as jquant
from aptai_tpu_torch.ops import quant as tquant

from _torch_port import one_torch_thread


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (M, K, N): the encoder's FFN widths, the second at a row count the card
# pads (≤ 16)
SHAPES = ((40, 1024, 4096), (5, 4096, 1024))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _bits(t):
    """The bit patterns of a torch or JAX array, for exact comparisons."""
    a = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)
    return a.view(np.uint32)


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    # round to the dtype once, so both sides start from the same values
    xt = torch.from_numpy(x).to(tdt)
    return xt, jnp.asarray(xt.float().numpy(), jdt)


@functools.lru_cache(maxsize=None)
def _jitted(name, *static):
    fn = getattr(jquant, name)
    return jax.jit(functools.partial(fn, **dict(static)) if static else fn)


# -- the ops against the jitted JAX functions ---------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_and_matmul_equal_jitted_jax(dtype, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    xt, xj = _pair(rng, (m, k), dtype)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    wt = torch.from_numpy(w.T.copy())  # nn.Linear's (N, K)

    codes, scale = tquant.dynamic_quantize(xt, -1)
    jcodes, jscale = _jitted("dynamic_quantize", ("axes", -1))(xj)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))
    wq = tquant.quantize_weight(wt)
    jwcodes, jwscale = _jitted("dynamic_quantize", ("axes", 0))(
        jnp.asarray(w))
    np.testing.assert_array_equal(wq.codes.numpy().T, np.asarray(jwcodes))
    np.testing.assert_array_equal(_bits(wq.scale), _bits(jwscale))

    got = tquant.w8a8_matmul(xt, wt)
    want = _jitted("w8a8_matmul")(xj, jnp.asarray(w))
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the layers' path: the weight quantized once, the product over codes
    assert torch.equal(tquant.w8a8_linear(tquant.quantize_rows(xt), wq,
                                          False, xt.dtype), got)
    # the int8 product is exact
    y = tquant.int8_mm(codes, wq.codes.t())
    assert torch.equal(y, tquant.int8_mm_plain(codes, wq.codes.t()))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_and_out_proj_equal_jitted_jax(dtype):
    b, t, h, d = 2, 9, 16, 64
    c = h * d
    rng = np.random.default_rng(7)
    xt, xj = _pair(rng, (b, t, c), dtype)
    w = (rng.standard_normal((c, c)) * 0.03).astype(np.float32)
    wt = torch.from_numpy(w.T.copy())
    got = tquant.w8a8_head_proj(xt, wt, h)
    want = jax.jit(lambda x, k: jquant.w8a8_head_proj(
        x, k.reshape(c, h, d)))(xj, jnp.asarray(w))
    assert got.shape == (b, h, t, d) and got.transpose(1, 2).is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(want))

    ct, cj = _pair(rng, (b, t, h, d), dtype)  # the kernel's buffer layout
    got = tquant.w8a8_out_proj(ct.transpose(1, 2), wt)
    want = jax.jit(lambda x, k: jquant.w8a8_out_proj(
        x, k.reshape(h, d, c)))(cj.transpose(0, 2, 1, 3), jnp.asarray(w))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_int8_mm_pads_rows_and_refuses_widths():
    rng = np.random.default_rng(8)
    b = torch.from_numpy(rng.integers(-127, 128, (24, 16)).astype(np.int8))
    for m in (0, 1, 16, 17):
        a = torch.from_numpy(rng.integers(-127, 128, (m, 24)).astype(np.int8))
        y = tquant.int8_mm(a, b)
        assert y.shape == (m, 16) and y.dtype == torch.int32
        assert torch.equal(y, tquant.int8_mm_plain(a, b))
    a = torch.zeros((20, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="contracted width K .* got 12"):
        tquant.int8_mm(a[:, :12], b[:12])
    with pytest.raises(ValueError, match="output width N .* got 12"):
        tquant.int8_mm(a, b[:, :12])


# -- the pins of tests/test_quant.py, on the port -----------------------------

def test_w8a8_exact_on_int8_grid():
    rng = np.random.default_rng(0)
    row_scales = np.array([0.5, 0.01, 3.0], np.float32)[:, None]
    col_scales = np.array([1.5, 0.25, 0.125, 2.0, 1.0, 0.5, 4.0, 0.75],
                          np.float32)[None, :]
    x = rng.integers(-127, 128, (3, 8)).astype(np.float32)
    w = rng.integers(-127, 128, (8, 8)).astype(np.float32)
    x[:, 0] = 127  # pin the max so the scale is exactly max/127
    w[0, :] = 127
    xs, ws = x * row_scales, w * col_scales
    got = tquant.w8a8_matmul(torch.from_numpy(xs),
                             torch.from_numpy(ws.T.copy()))
    np.testing.assert_allclose(got.numpy(), xs @ ws, rtol=1e-6)


def test_w8a8_zero_rows_stay_zero():
    out = tquant.w8a8_matmul(torch.zeros(4, 16), torch.ones(8, 16))
    assert torch.all(out == 0) and torch.isfinite(out).all()


def test_w8a8_deviation_bound_gaussian():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 1024)).astype(np.float32)
    w = (rng.standard_normal((1024, 512)) * 0.02).astype(np.float32)
    got = tquant.w8a8_matmul(torch.from_numpy(x),
                             torch.from_numpy(w.T.copy())).numpy()
    want = x @ w
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.015


def test_dynamic_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 64)).astype(np.float32))
    q, s = tquant.dynamic_quantize(x, -1)
    assert q.dtype == torch.int8
    assert torch.all((q.float() * s - x).abs() <= 0.5 * s + 1e-7)


def test_head_and_out_proj_match_matmul_layout():
    rng = np.random.default_rng(3)
    b, t, c, h, d = 2, 6, 16, 4, 4
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, c)) * 0.1)
                         .astype(np.float32))
    want = tquant.w8a8_matmul(x, w).reshape(b, t, h, d).transpose(1, 2)
    torch.testing.assert_close(tquant.w8a8_head_proj(x, w, h), want,
                               rtol=1e-5, atol=1e-6)
    ctx = torch.from_numpy(rng.standard_normal((b, h, t, d))
                           .astype(np.float32))
    want = tquant.w8a8_matmul(ctx.transpose(1, 2).reshape(b, t, c), w)
    torch.testing.assert_close(tquant.w8a8_out_proj(ctx, w), want,
                               rtol=1e-5, atol=1e-6)
