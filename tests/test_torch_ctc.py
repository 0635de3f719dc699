"""aptai_tpu_torch CTC against the JAX package: the loss on feasible and
infeasible items, a zero-length target and repeated labels, its gradient
with respect to the logits, the greedy decode with its truncation count,
and the host prefix beam search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.decode.beam import beam_search as jax_beam_search
from aptai_tpu.ops import ctc as jctc
from aptai_tpu_torch.decode import beam_search, decode_best, decode_with_times
from aptai_tpu_torch.ops import ctc as tctc


def _case(seed, b=5, t=30, v=7, s=8):
    """Random logits, lengths and targets; item 0 is infeasible (12 labels,
    each repeated, in 14 frames: repeats need a blank between them), item 1
    has an empty target, item 2 repeated labels."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    in_len = rng.integers(t // 2, t + 1, b).astype(np.int32)
    tl = rng.integers(1, s + 1, b).astype(np.int32)
    tg = rng.integers(1, v, (b, s + 4)).astype(np.int32)
    in_len[0], tl[0] = 14, 12
    tg[0, :12] = np.repeat(rng.integers(1, v, 6), 2)
    tl[1] = 0
    tg[2, :4] = [3, 3, 3, 5]
    tl[2] = max(tl[2], 4)
    return logits, in_len, tg, tl


def _jax_loss(logits, in_len, tg, tl, reduction):
    lp = jax.nn.log_softmax(logits, axis=-1)
    return jctc.ctc_loss(lp, in_len, tg, tl, reduction=reduction)


def _torch_loss(logits, in_len, tg, tl, reduction):
    lp = torch.log_softmax(logits, dim=-1)
    return tctc.ctc_loss(lp, in_len, tg, tl, reduction=reduction)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_logit_gradients_match_jax(seed):
    logits, in_len, tg, tl = _case(seed)
    args = [jnp.asarray(a) for a in (in_len, tg, tl)]
    targs = [torch.from_numpy(a) for a in (in_len, tg, tl)]
    per_item = _torch_loss(torch.from_numpy(logits), *targs, "none")
    want_item = np.asarray(_jax_loss(jnp.asarray(logits), *args, "none"))
    # infeasible item 0 counts 0 (zero_infinity); the others are finite
    assert per_item[0].item() == 0.0 and want_item[0] == 0.0
    assert np.isfinite(want_item).all() and (want_item[1:] > 0).all()
    # float32 recursions in both, over 30 steps
    np.testing.assert_allclose(per_item.numpy(), want_item, rtol=1e-5,
                               atol=1e-5)

    x = torch.from_numpy(logits).requires_grad_()
    loss = _torch_loss(x, *targs, "mean")
    loss.backward()
    want_loss, want_grad = jax.value_and_grad(
        lambda lg: _jax_loss(lg, *args, "mean"))(jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)
    # the infeasible item gets no gradient; padded frames get none
    assert (x.grad[0] == 0).all()
    for b in range(1, len(in_len)):
        assert (x.grad[b, in_len[b]:] == 0).all()


def test_ctc_loss_reductions_match_jax():
    logits, in_len, tg, tl = _case(2)
    args = [jnp.asarray(a) for a in (in_len, tg, tl)]
    targs = [torch.from_numpy(a) for a in (in_len, tg, tl)]
    for reduction in ("sum", "mean"):
        got = _torch_loss(torch.from_numpy(logits), *targs, reduction)
        want = _jax_loss(jnp.asarray(logits), *args, reduction)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    score = tctc.ctc_forward_score(torch.log_softmax(
        torch.from_numpy(logits), -1), *targs)
    want = jctc.ctc_forward_score(jax.nn.log_softmax(jnp.asarray(logits)),
                                  *args)
    np.testing.assert_allclose(score.numpy(), np.asarray(want), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown reduction"):
        _torch_loss(torch.from_numpy(logits), *targs, "avg")


@pytest.mark.parametrize("max_len", [None, 3])
def test_greedy_decode_matches_jax(max_len):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 25, 6)).astype(np.float32)
    logits[1, :, 0] += 5.0            # mostly blank
    logits[2, 3:9, 4] += 9.0          # one long run of label 4
    in_len = np.array([25, 20, 12, 1], np.int32)
    got = tctc.greedy_decode(torch.from_numpy(logits),
                             torch.from_numpy(in_len),
                             max_output_length=max_len,
                             return_truncated=True)
    want = jctc.greedy_decode(jnp.asarray(logits), jnp.asarray(in_len),
                              max_output_length=max_len,
                              return_truncated=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if max_len is not None:
        assert got[2].max().item() > 0  # the cap dropped tokens
    toks, lens = tctc.greedy_decode(torch.from_numpy(logits),
                                    torch.from_numpy(in_len))
    assert toks.shape == (4, 25) and lens.shape == (4,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 6)) * 2.0
    logits[::3, 0] += 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lp = lp.astype(np.float32)
    got = beam_search(lp, nbest=3)
    want = jax_beam_search(lp, nbest=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.timesteps == w.timesteps
        assert g.score == pytest.approx(w.score, rel=1e-12)
    assert decode_best(lp) == list(want[0].tokens)
    assert decode_with_times(lp) == (list(want[0].tokens),
                                     list(want[0].timesteps))
