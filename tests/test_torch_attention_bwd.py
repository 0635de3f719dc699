"""aptai_tpu_torch attention backward (plain version and the autograd path,
the CPU route) against the JAX package's Pallas flash backward (interpret
mode) and XLA autodiff, float32; the logsumexp against the one JAX saves;
zero-length items; gradcheck; the CUDA wrappers' input checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.ops import attention as jatt
from aptai_tpu_torch.ops import attention as tatt


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _row_weights(b, t, lengths):
    """(B, 1, T, 1): 1 on each item's valid query rows, 0 on pad rows."""
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)[:, None, :, None]


@pytest.mark.parametrize("shape,lengths", [
    ((2, 2, 200, 64), [200, 130]),    # ragged, T off the 128 grid
    ((1, 2, 600, 64), [530]),         # T > 512: several key and query tiles
    ((2, 3, 77, 64), [1, 77]),        # one valid key; T < one tile
])
def test_backward_matches_jax_flash_and_xla(interpret, shape, lengths):
    """loss = Σ w · out² over valid query rows; the port's autograd path
    and its plain backward called directly, against jax.grad through the
    Pallas flash custom VJP and through XLA attention, at the tolerance of
    the JAX package's own flash-vs-XLA gradient test."""
    b, h, t, d = shape
    q, k, v = _inputs(4, *shape)
    w = _row_weights(b, t, lengths)
    lens = np.asarray(lengths, np.int32)
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))

    def jax_grads(attn):
        return [np.asarray(g) for g in jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(w * attn(q, k, v, jl) ** 2),
            argnums=(0, 1, 2)))(jq, jk, jv)]

    want_flash = jax_grads(jatt._mha_bhtd_flash)
    want_xla = jax_grads(jatt._xla_attention_bhtd)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tl = torch.from_numpy(lens)
    out = tatt.multi_head_attention_bhtd(tq, tk, tv, tl)
    (torch.from_numpy(w) * out ** 2).sum().backward()
    autograd = [x.grad.numpy() for x in (tq, tk, tv)]

    with torch.no_grad():
        o, lse = tatt.flash_attention_bhtd_plain(tq, tk, tv, tl,
                                                 return_lse=True)
        plain = [x.numpy() for x in tatt.flash_attention_bhtd_bwd_plain(
            tq, tk, tv, o, lse, 2 * torch.from_numpy(w) * o, tl)]

    for got in (autograd, plain):
        for g, wf, wx, name in zip(got, want_flash, want_xla, "qkv"):
            np.testing.assert_allclose(g, wf, rtol=2e-3, atol=2e-4,
                                       err_msg=f"d{name} vs JAX flash")
            np.testing.assert_allclose(g, wx, rtol=2e-3, atol=2e-4,
                                       err_msg=f"d{name} vs XLA autodiff")

    # the logsumexp against the one the JAX flash forward saves
    _, jlse = jatt._flash_fwd_bhtd(jq, jk, jv, jl, save_lse=True)
    jlse = np.asarray(jlse)[:, :t, 0].reshape(b, h, t)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)


def test_zero_length_item_has_zero_gradients(interpret):
    """A row with no valid key: output 0, logsumexp +inf, and gradients
    exactly 0 with no NaN anywhere, on the autograd path and through the
    plain backward. The JAX flash backward agrees: it masks by column, so
    its gradients for such an item are 0 too (its forward gives ΣV/Tp)."""
    b, h, t, d = 2, 2, 200, 64
    q, k, v = _inputs(5, b, h, t, d)
    lens = np.array([0, 150], np.int32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.multi_head_attention_bhtd(tq, tk, tv, torch.from_numpy(lens))
    # a loss whose gradient is nonzero on the empty item's output rows too
    (out ** 2 + out).sum().backward()
    assert torch.all(out[0] == 0)
    for x in (tq, tk, tv):
        assert torch.isfinite(x.grad).all()
        assert torch.all(x.grad[0] == 0)
        assert x.grad[1].abs().max() > 0
    _, lse = tatt.flash_attention_bhtd_plain(tq, tk, tv,
                                             torch.from_numpy(lens),
                                             return_lse=True)
    assert torch.all(torch.isinf(lse[0]) & (lse[0] > 0))
    assert torch.isfinite(lse[1]).all()

    jgrads = jax.grad(
        lambda q, k, v: jnp.sum(jatt._mha_bhtd_flash(q, k, v,
                                                     jnp.asarray(lens))),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g in jgrads:
        assert np.all(np.asarray(g)[0] == 0)


def test_gradcheck_float64():
    """The autograd Function with the plain forward and backward inside,
    in float64: the analytic gradient against finite differences, with a
    ragged and an empty item."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 1, 6, 4))
                                ).requires_grad_() for _ in range(3))
    lens = torch.tensor([4, 0], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt.FlashAttention.apply(q, k, v, lens), (q, k, v))


def test_cpu_gradient_routes_to_plain_backward(monkeypatch):
    """A CPU tensor that needs a gradient goes through FlashAttention with
    the plain forward (with logsumexp) and the plain backward; no kernel
    wrapper counts a launch."""
    calls = []
    plain_bwd = tatt.flash_attention_bhtd_bwd_plain
    monkeypatch.setattr(tatt, "flash_attention_bhtd_bwd_plain",
                        lambda *a: calls.append("bwd") or plain_bwd(*a))
    before = [f.launches for f in (tatt.flash_attention_bhtd_cuda,
                                   tatt.flash_attention_bwd_dq_cuda,
                                   tatt.flash_attention_bwd_dkv_cuda)]
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(7, 1, 2, 9, 64))
    tatt.multi_head_attention_bhtd(q, k, v, None).sum().backward()
    assert calls == ["bwd"]
    assert [f.launches for f in (tatt.flash_attention_bhtd_cuda,
                                 tatt.flash_attention_bwd_dq_cuda,
                                 tatt.flash_attention_bwd_dkv_cuda)] == before


def test_backward_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers check their inputs before they build
    anything: CPU tensors raise, and nothing falls back."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(8, 1, 2, 9, 64))
    lse = delta = torch.zeros((1, 2, 9))
    lens = torch.tensor([9], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bwd_dq_cuda(q, k, v, q, lse, q, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, delta, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bwd_cuda(q, k, v, q, lse, q, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bhtd_cuda(q, k, v, lens, return_lse=True)


def _jax_flash_backward(q, k, v, out, lse, dout, lengths, jdt):
    """(dq, dk, dv, Δ) of the JAX package's flash backward on the port's
    forward output and logsumexp: ``_mha_bhtd_flash_bwd``, which calls
    ``_bwd_call`` (interpret mode under the fixture), and its Δ expression
    over the same padded rows."""
    b, h, t, d = q.shape
    tp = jatt._tiles(b, t, h)[0]
    # pad rows past T have q = dO = 0, so any lse there gives zero terms
    lse_p = np.full((b * h, tp, 1), np.inf, np.float32)
    lse_p[:, :t, 0] = lse.reshape(b * h, t)
    lse_j = jnp.broadcast_to(jnp.asarray(lse_p), (b * h, tp, jatt.LSE_LANES))
    jq, jk, jv, jo, jg = (jnp.asarray(x, jdt) for x in (q, k, v, out, dout))
    grads = jatt._mha_bhtd_flash_bwd(
        (jq, jk, jv, jnp.asarray(lengths), lse_j, jo), jg)[:3]
    delta = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1)
    return [np.asarray(x.astype(jnp.float32)) for x in (*grads, delta)]


@pytest.mark.parametrize("shape,lengths,dtype", [
    ((2, 2, 249, 64), [249, 190], "float32"),   # 4 tiles, the last of 57
    ((2, 2, 249, 64), [0, 1], "float32"),       # no valid key; one
    ((2, 2, 50, 64), [50, 1], "float32"),       # T <= 64: one ragged tile
    ((1, 2, 64, 64), [0], "float32"),           # T = 64, no valid key
    ((2, 2, 249, 64), [249, 130], "bfloat16"),  # the kernels' dtype
])
def test_dq_and_dkv_plain_match_jax_bwd_call(interpret, shape, lengths,
                                             dtype):
    """The dq kernel's plain function (dq and the Δ it hands on) and the
    dk/dv kernel's (fed that Δ) against the JAX package's Pallas backward
    on the same forward output and logsumexp; Δ against attention_delta
    and against the JAX package's Δ."""
    b, h, t, d = shape
    q, k, v = _inputs(9, *shape)
    dout = np.random.default_rng(10).standard_normal(shape).astype(
        np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, dout))
    tl = torch.tensor(lengths, dtype=torch.int32)
    out, lse = tatt.flash_attention_bhtd_plain(tq, tk, tv, tl,
                                               return_lse=True)
    dq, delta = tatt.flash_attention_bwd_dq_plain(tq, tk, tv, out, lse, tg,
                                                  tl)
    dk, dv = tatt.flash_attention_bwd_dkv_plain(tq, tk, tv, tg, lse, delta,
                                                tl)
    assert delta.dtype == torch.float32 and delta.shape == (b, h, t)
    assert all(x.dtype == tdt for x in (dq, dk, dv))
    assert torch.equal(delta, tatt.attention_delta(out, tg))
    # the composed backward is exactly the two kernels' functions
    for got, want in zip(tatt.flash_attention_bhtd_bwd_plain(
            tq, tk, tv, out, lse, tg, tl), (dq, dk, dv)):
        assert torch.equal(got, want)

    want = _jax_flash_backward(
        *(x.float().numpy() for x in (tq, tk, tv, out)), lse.numpy(),
        tg.float().numpy(), np.asarray(lengths, np.int32),
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    # Δ: f32 sums of the same 64 products in two orders
    np.testing.assert_allclose(delta.numpy(), want[3], rtol=1e-5, atol=1e-5)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[:3]):
        got = got.float().numpy()
        if dtype == "float32":
            # f32 in both: the products' summation order and exp's ulps
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=5e-5,
                                       err_msg=name)
        else:
            # bf16 rounding of p and ds before their products may fall on
            # the other side of a boundary when the f32 sums before it
            # differ in their last bit: relative to the largest magnitude,
            # as the card's check holds the kernels
            err = np.abs(got - w).max()
            assert err <= 2e-2 * max(np.abs(w).max(), 1e-30), (name, err)
        for i, n in enumerate(lengths):
            if n == 0:
                assert np.all(got[i] == 0), name
        assert np.isfinite(got).all()


def test_dq_wrapper_checks_the_forward_output():
    """The dq kernel's wrapper takes the forward's output ``out`` like its
    other (B, H, T, 64) inputs: a CPU tensor, a head dim that is not
    contiguous, or another shape raises before anything is built."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, 1, 2, 9, 64))
    lse = torch.zeros((1, 2, 9))
    lens = torch.tensor([9], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bwd_dq_cuda(q, k, v, q.clone(), lse, q, lens)
    strided = torch.zeros((1, 2, 64, 9)).transpose(-1, -2)  # (1, 2, 9, 64)
    with pytest.raises(ValueError, match="out needs a contiguous head dim"):
        tatt.flash_attention_bwd_dq_cuda(q, k, v, strided, lse, q, lens)
    with pytest.raises(ValueError, match="one .B, H, T, D. shape"):
        tatt.flash_attention_bwd_dq_cuda(q, k, v, q[:, :, :8], lse, q, lens)
    with pytest.raises(ValueError, match="out needs a contiguous head dim"):
        tatt.flash_attention_bwd_cuda(q, k, v, strided, lse, q, lens)


def test_backward_library_is_keyed_by_sources_and_header():
    from aptai_tpu_torch.ops import kernels

    path = kernels.library_path("flash_attn_bwd")
    assert path.name.startswith("libflash_attn_bwd-") and path.suffix == ".so"
    assert (kernels.CSRC / "flash_attn_bwd.cu").exists()
    assert (kernels.CSRC / "flash_attn_common.cuh").exists()
    assert path != kernels.library_path("flash_attn_fwd")
