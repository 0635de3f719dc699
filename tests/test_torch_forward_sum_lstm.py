"""aptai_tpu_torch's FORCE-APTAI building blocks against the JAX package,
float32 on the CPU: the packed (bi)LSTM (outputs, final states and
gradients, ragged lengths with 1 and 0), the ForwardSum loss and its
gradient (a feasible, a barely feasible and an infeasible item, with and
without the off-diagonal prior, two blank scores), and the head modules
(CrossAttention, PhonemeEncoder with a nonzero row 0, RNNHead, ConvBank)
against their Flax counterparts."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import modules as jmod
from aptai_tpu.ops import forward_sum as jfs
from aptai_tpu_torch.models import modules as tmod
from aptai_tpu_torch.ops import forward_sum as tfs

# both packages' ops/__init__ export a function named lstm over the module
jlstm = importlib.import_module("aptai_tpu.ops.lstm")
tlstm = importlib.import_module("aptai_tpu_torch.ops.lstm")

from _torch_port import (dense_sd, jax_lstm_one_step_a_loop, module_params,
                         one_torch_thread, torch_grads)

# float32 on both sides: summation order and exp/tanh ulps
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _lstm_case(seed, b=5, t=7, i=4, h=6):
    """Inputs, ragged lengths (full, 1, 0, mid, near-full), two directions'
    weights and output cotangents."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    lengths = np.array([t, 1, 0, 4, t - 1], np.int32)
    bound = 1 / np.sqrt(h)
    params = [[rng.uniform(-bound, bound, s).astype(np.float32)
               for s in ((4 * h, i), (4 * h, h), (4 * h,), (4 * h,))]
              for _ in range(2)]
    return x, lengths, params


MODES = ("forward", "reverse", "bidirectional")


def _lstm_fns(mode, lstm_mod, params):
    """``fn(x, lengths, p)`` of one package for ``mode``, and the weights
    it takes."""
    if mode == "bidirectional":
        return (lambda x, l, p: lstm_mod.bilstm(
            x, l, lstm_mod.LSTMParams(*p[0]), lstm_mod.LSTMParams(*p[1])),
            params)
    rev = mode == "reverse"
    return (lambda x, l, p: lstm_mod.lstm(x, l, lstm_mod.LSTMParams(*p),
                                          rev), params[0])


@pytest.fixture(scope="module")
def lstm_jax():
    """For each mode: the JAX outputs and states, and the gradients of
    Σ cotangent · (outputs, states) with respect to x and every weight,
    all three modes in one compiled program."""
    x, lengths, params = _lstm_case(0)
    rng = np.random.default_rng(1)
    cots = {}
    for mode in MODES:
        fn, p = _lstm_fns(mode, jlstm, params)
        shapes = jax.eval_shape(lambda x, p: fn(x, lengths, p), x, p)
        cots[mode] = [rng.standard_normal(a.shape).astype(np.float32)
                      for a in jax.tree.leaves(shapes)]

    def run(x, params):
        res = {}
        for mode in MODES:
            fn, p = _lstm_fns(mode, jlstm, params)

            def loss(x, p):
                out, states = fn(x, lengths, p)
                flat = [out] + jax.tree.leaves(states)
                return sum(jnp.sum(a * c)
                           for a, c in zip(flat, cots[mode])), flat

            (_, flat), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(x, p)
            res[mode] = (flat, grads)
        return res

    return (x, lengths, params, cots,
            jax.jit(run)(x, jax.tree.map(jnp.asarray, params)))


@pytest.mark.parametrize("mode", MODES)
def test_lstm_outputs_states_and_gradients_match_jax(lstm_jax, mode):
    x, lengths, params, cots, res = lstm_jax
    want, (gx_want, gp_want) = res[mode]
    tfn, p = _lstm_fns(mode, tlstm, params)
    xt = torch.from_numpy(x).requires_grad_()
    pt = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    out, states = tfn(xt, torch.from_numpy(lengths), pt)
    got = [out] + jax.tree.leaves(states)
    sum((a * torch.from_numpy(c)).sum()
        for a, c in zip(got, cots[mode])).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    # zero past each length (the empty row included), in every direction
    pad = np.arange(x.shape[1])[None, :] >= lengths[:, None]
    assert not out.detach().numpy()[pad].any()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_want), **TOL)
    assert not xt.grad.numpy()[2].any()  # the length-0 row
    for g, w in zip(jax.tree.leaves(torch_grads(pt)),
                    jax.tree.leaves(gp_want)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def _fs_case():
    """Scores for a feasible (20 frames, 6 tokens), a barely feasible (5
    frames, 5 tokens: one path) and an infeasible item (3 frames, 5
    tokens), 8 text columns."""
    rng = np.random.default_rng(7)
    scores = rng.standard_normal((3, 20, 8)).astype(np.float32) * 2
    text = np.array([6, 5, 5], np.int32)
    mel = np.array([20, 5, 3], np.int32)
    return scores, text, mel


FS_CASES = [(prior, blank) for prior in (False, True)
            for blank in (-1.0, -2.5)]


@pytest.fixture(scope="module")
def forward_sum_jax():
    """The JAX loss and its gradient for every case, and the prior, in one
    compiled program."""
    scores, text, mel = _fs_case()

    def run(s):
        out = {case: jax.value_and_grad(lambda s: jfs.forward_sum_loss(
            s, text, mel, blank_logprob=case[1], off_diag_prior=case[0]))(s)
            for case in FS_CASES}
        return out, jfs.off_diag_prior_logprobs(20, 8, jnp.asarray(text),
                                                jnp.asarray(mel))

    return (scores, text, mel) + tuple(jax.jit(run)(scores))


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("blank", [-1.0, -2.5])
def test_forward_sum_loss_and_gradient_match_jax(forward_sum_jax, prior,
                                                 blank):
    scores, text, mel, res, prior_lp = forward_sum_jax
    want, gwant = res[(prior, blank)]
    st = torch.from_numpy(scores).requires_grad_()
    got = tfs.forward_sum_loss(st, torch.from_numpy(text),
                               torch.from_numpy(mel), blank_logprob=blank,
                               off_diag_prior=prior, prior_g=0.2)
    got.backward()
    # losses to 1e-5 relative; the gradient to 1e-5 of its largest entry
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    gw = np.asarray(gwant)
    np.testing.assert_allclose(st.grad.numpy(), gw, rtol=0,
                               atol=1e-5 * np.abs(gw).max())
    # the infeasible item is cut (zero_infinity): no gradient reaches it
    assert not st.grad.numpy()[2].any()
    if prior:
        lp = tfs.off_diag_prior_logprobs(20, 8, torch.from_numpy(text),
                                         torch.from_numpy(mel))
        np.testing.assert_allclose(lp.numpy(), np.asarray(prior_lp), **TOL)


def _module_inputs():
    rng = np.random.default_rng(10)
    return {
        "xatt": (rng.standard_normal((2, 9, 16)).astype(np.float32),
                 rng.standard_normal((2, 6, 12)).astype(np.float32),
                 np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]],
                          np.int32)),
        "phn": (np.array([[3, 7, 1, 0, 0], [0, 2, 2, 9, 0]], np.int32),),
        "rnn": (rng.standard_normal((3, 7, 10)).astype(np.float32),
                np.array([7, 3, 1], np.int32)),
        "bank": (rng.standard_normal((2, 11, 10)).astype(np.float32),),
    }


@pytest.fixture(scope="module")
def flax_heads():
    """Each Flax head module with parameters drawn with numpy in its own
    tree's shapes (biases and scales not zeros and ones), and its
    deterministic output, all four in one compiled program."""
    modules = {"xatt": jmod.CrossAttention(att_dim=8),
               "phn": jmod.PhonemeEncoder(vocab_size=11, dim=8, max_len=10),
               "rnn": jmod.RNNHead(hidden_dim=6, out_dim=9),
               "bank": jmod.ConvBank(output_class_num=5)}
    inputs = _module_inputs()
    rng = np.random.default_rng(4)
    params = {}
    for name, m in modules.items():
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                                *inputs[name])["params"]
        params[name] = jax.tree.map(
            lambda a: (0.3 * rng.standard_normal(a.shape)).astype(
                np.float32), shapes)
    outs = jax.jit(lambda p: {n: m.apply({"params": p[n]}, *inputs[n])
                              for n, m in modules.items()})(params)
    return inputs, params, outs


def test_cross_attention_matches_flax(flax_heads):
    inputs, params, outs = flax_heads
    params, (att_out, energy) = params["xatt"], outs["xatt"]
    m = tmod.CrossAttention(16, 12, 8)
    sd = dense_sd(params, ("q", "k"))
    sd.update(module_params(params, {"layer_norm": "layer_norm"}))
    m.load_state_dict(sd, strict=True)
    got_out, got_energy = m(*(torch.from_numpy(a) for a in inputs["xatt"]))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(att_out),
                               **TOL)
    # the pad mask is inside the energies
    np.testing.assert_allclose(got_energy.detach().numpy(),
                               np.asarray(energy), **TOL)
    assert np.asarray(energy)[1, :, 2:].max() < -900


def test_phoneme_encoder_masks_row_zero_like_flax(flax_heads):
    inputs, params, outs = flax_heads
    table = np.asarray(params["phn"]["embed"]["embedding"])
    assert np.abs(table[0]).min() > 0  # row 0 is nonzero in the loaded table
    m = tmod.PhonemeEncoder(11, 8, max_len=10).eval()
    m.load_state_dict({"embed.weight": torch.from_numpy(table)}, strict=True)
    got = m(torch.from_numpy(inputs["phn"][0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(outs["phn"]),
                               **TOL)
    np.testing.assert_array_equal(
        m.pe.numpy(), jmod.sinusoidal_positional_encoding(10, 8))


def test_rnn_head_matches_flax(flax_heads):
    inputs, params, outs = flax_heads
    params, (want, want_hidden) = params["rnn"], outs["rnn"]
    m = tmod.RNNHead(10, 6, 9).eval()
    sd = dense_sd(params, ("linear_0", "linear_1"))
    for jd, sfx in (("fwd", ""), ("bwd", "_reverse")):
        for jn, tn in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                       ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"lstm.{tn}_l0{sfx}"] = torch.from_numpy(
                np.asarray(params[f"{jn}_{jd}"]))
    m.load_state_dict(sd, strict=True)
    got, hidden = m(*(torch.from_numpy(a) for a in inputs["rnn"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hidden.detach().numpy(),
                               np.asarray(want_hidden), **TOL)


def test_conv_bank_matches_flax(flax_heads):
    inputs, params, outs = flax_heads
    params = params["bank"]
    m = tmod.ConvBank(10, 5).eval()
    sd = dense_sd(params, ("in_linear", "out_linear"))
    for i in range(3):
        conv = params[f"cnn_{i}"]
        sd[f"cnns.{i}.weight"] = torch.from_numpy(
            np.asarray(conv["kernel"]).transpose(2, 1, 0).copy())
        sd[f"cnns.{i}.bias"] = torch.from_numpy(np.asarray(conv["bias"]))
    m.load_state_dict(sd, strict=True)
    got = m(torch.from_numpy(inputs["bank"][0]))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(outs["bank"]), **TOL)
