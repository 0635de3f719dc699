"""aptai_tpu_torch attention (plain version, the CPU path) against the JAX
package's Pallas flash forward (interpret mode) and its XLA path, f32."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.ops import attention as jatt
from aptai_tpu_torch.ops.attention import (flash_attention_bhtd_plain,
                                           multi_head_attention_bhtd)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _port(q, k, v, lengths):
    return flash_attention_bhtd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if lengths is None else torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("shape,lengths", [
    ((2, 2, 200, 64), [200, 130]),    # ragged, T off the 128 grid
    ((1, 2, 600, 64), [530]),         # T > 512: several key blocks
    ((2, 3, 77, 64), [1, 77]),        # one valid key; T < one block
    ((2, 2, 130, 64), None),          # dense
])
def test_plain_matches_jax_flash_and_xla(interpret, shape, lengths):
    q, k, v = _inputs(0, *shape)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    got = _port(q, k, v, lens)
    jl = None if lens is None else jnp.asarray(lens)
    flash = np.asarray(jatt.flash_attention_bhtd(
        *map(jnp.asarray, (q, k, v)), jl))
    xla = np.asarray(jatt._xla_attention_bhtd(
        *map(jnp.asarray, (q, k, v)), jl))
    # every query row, including rows past the item's length
    np.testing.assert_allclose(got, flash, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-5)


def test_zero_length_item_pins_each_path(interpret):
    """A row with no valid key: the port gives 0 (the semantics its CUDA
    kernel shares). The JAX paths differ from it and from each other: XLA
    gives the mean of V over the T keys, and the flash kernel, whose -1e30
    mask makes every masked logit equal to its running max, gives the sum
    of V over T divided by the padded length Tp."""
    b, h, t, d = 2, 2, 200, 64
    q, k, v = _inputs(1, b, h, t, d)
    lens = np.array([0, 150], np.int32)
    got = _port(q, k, v, lens)
    flash = np.asarray(jatt.flash_attention_bhtd(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(lens)))
    xla = np.asarray(jatt._xla_attention_bhtd(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(lens)))

    assert np.all(got[0] == 0.0)
    t_padded = jatt._tiles(b, t, h)[0]
    np.testing.assert_allclose(
        flash[0], np.broadcast_to(v[0].sum(1, keepdims=True) / t_padded,
                                  flash[0].shape), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        xla[0], np.broadcast_to(v[0].mean(1, keepdims=True), xla[0].shape),
        rtol=1e-4, atol=1e-5)
    # the item with valid keys agrees everywhere
    np.testing.assert_allclose(got[1], flash[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], xla[1], rtol=1e-4, atol=1e-5)


def test_plain_takes_strided_views_and_bf16():
    """The model hands attention (B, T, H, D) projections viewed as
    (B, H, T, D); bf16 rounds P before P·V, so it sits within bf16 error."""
    b, t, h, d = 2, 50, 4, 64
    rng = np.random.default_rng(2)
    btxhd = [torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)) for _ in range(3)]
    lens = torch.tensor([50, 20], dtype=torch.int32)
    views = [x.transpose(1, 2) for x in btxhd]
    dense = [x.contiguous() for x in views]
    want = flash_attention_bhtd_plain(*dense, lens)
    torch.testing.assert_close(flash_attention_bhtd_plain(*views, lens), want,
                               rtol=0, atol=0)
    got16 = multi_head_attention_bhtd(*(x.bfloat16() for x in views), lens)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want, rtol=0, atol=2e-2)
