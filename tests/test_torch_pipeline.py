"""aptai_tpu_torch's pipe axis (``parallel/pipeline.py``) against the JAX
package's, on the CPU: ``tests/test_pipeline.py``'s cases over four gloo
ranks (one spawn, ``_torch_parallel_worker.py``'s ``pipeline`` scenario,
importing the port only) on the tiny config with four layers and the JAX
file's batch (4 items of 3200 / 2400 / 3200 / 1600 samples).

* GPipe forwards at (S, M) = (4, 2), (4, 4) and (2, 4), the interleaved
  ones at (S, M, V) = (2, 2, 2) and (2, 4, 2), and the data × pipe forward
  on a (data, pipe) = (2, 2) mesh, each on every rank against the JAX
  package's sequential encoder (``atol=rtol=1e-5``), the GPipe (2, 4) one
  also against the JAX ``pipelined_encoder_apply`` itself; each rank's
  attention calls are ``M · L/S``, one a layer a microbatch (no idle
  tick computes);
* the gradients of ``mean(h²)`` through GPipe (4, 2) and the interleaved
  (2, 2, 2), the model in ``train()`` mode, every parameter against
  ``jax.grad`` of the sequential encoder (``atol=2e-5, rtol=1e-4``): each
  layer's on the one rank of a pipe group that holds it, the rest equal
  on every rank; each rank holds ``1/S`` of the stack's bytes;
* the refusals, with the JAX package's error types and texts, and the
  model axis's;
* the stack round trip and the schedule's arithmetic against the JAX
  functions.

The JAX references are computed before the ranks start, so that no XLA
compile runs beside them. Weights cross from the JAX tree through
``encoder_state_dict_from_jax``, gradients too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aptai_tpu.models import Wav2Vec2Encoder
from aptai_tpu.models import configs as jcfg
from aptai_tpu.parallel import pipeline as jpipe
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import encoder_state_dict_from_jax
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from aptai_tpu_torch.parallel import pipeline as tpipe

import _torch_parallel_worker as worker
from _torch_port import random_jax_aptai_params

CFG = dict(num_hidden_layers=4)
LAYERS = CFG["num_hidden_layers"]
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
MESH_STAGES = {"pipe4": 4, "pairs": 2}


@pytest.fixture(scope="module")
def setup():
    params = random_jax_aptai_params(tcfg.tiny_config(**CFG), 11,
                                     seed=4)["encoder"]
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((4, 3200)).astype(np.float32)
    lens = np.array([3200, 2400, 3200, 1600], np.int32)
    return {"params": params, "audio": audio, "lens": lens,
            "sd": encoder_state_dict_from_jax(params)}


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return ("ValueError", str(e.value))


@pytest.fixture(scope="module")
def jax_ref(setup):
    """The JAX package's sequential forward and gradients of ``mean(h²)``,
    its GPipe (2, 4) forward and its refusals' texts."""
    enc = Wav2Vec2Encoder(jcfg.tiny_config(**CFG))
    variables = {"params": jax.tree.map(jnp.asarray, setup["params"])}
    audio, lens = jnp.asarray(setup["audio"]), jnp.asarray(setup["lens"])

    def loss(v):
        h, fl, _ = enc.apply(v, audio, lens, deterministic=True)
        return jnp.mean(h ** 2), (h, fl)

    # the forward and the gradients in one compiled program
    (_, (h, fl)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables)
    grads = grads["params"]
    devs = np.asarray(jax.devices())

    def pipelined(v, n_stages, m, interleave=1):
        mesh = Mesh(devs[:n_stages], ("pipe",))
        with mesh:
            return jpipe.pipelined_encoder_apply(
                enc, v, audio, lens, mesh, num_microbatches=m,
                interleave=interleave)[0]

    # the refusals raise while the JAX function traces: no compile
    refusals = {name: _jax_error(lambda a=args: jax.eval_shape(
        lambda v: pipelined(v, *a), variables))
        for name, args in (("ragged_groups", (2, 1, 2)),
                           ("microbatches", (4, 3)), ("stages", (3, 2)))}
    return {"h": np.asarray(h), "fl": np.asarray(fl),
            "grads": {k: v.numpy() for k, v in encoder_state_dict_from_jax(
                jax.tree.map(np.asarray, grads)).items()},
            "gpipe_2_4": np.asarray(jax.jit(
                lambda v: pipelined(v, 2, 4))(variables)),
            "refusals": refusals}


@pytest.fixture(scope="module")
def ranks(setup, jax_ref, tmp_path_factory):
    """The four ranks, started once the JAX references are done."""
    inp = {"cfg": CFG, **{k: setup[k] for k in ("sd", "audio", "lens")}}
    return worker.finish(worker.start(
        "pipeline", inp, tmp_path_factory.mktemp("ranks"), world=4))


@pytest.mark.parametrize("name", sorted(worker.PIPE_FORWARDS))
def test_pipe_forward_matches_jax(ranks, jax_ref, name):
    mesh, m, _, data_axis = worker.PIPE_FORWARDS[name]
    s = MESH_STAGES[mesh]
    for r, out in enumerate(ranks):
        got = out[name]
        want, fl = jax_ref["h"], jax_ref["fl"]
        if data_axis is not None:  # rank r's data index is r // 2
            rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
            want, fl = want[rows], fl[rows]
        np.testing.assert_array_equal(got["fl"], fl)
        np.testing.assert_allclose(got["h"], want, **FWD_TOL)
        if name == "gpipe_2_4":
            np.testing.assert_allclose(got["h"], jax_ref["gpipe_2_4"],
                                       **FWD_TOL)
        assert got["calls"] == m * LAYERS // s, (r, got["calls"])
        assert not out["jax_loaded"]


@pytest.mark.parametrize("name", sorted(worker.PIPE_GRADS))
def test_pipe_gradients_match_jax(ranks, jax_ref, name):
    mesh, m, _ = worker.PIPE_GRADS[name]
    s = MESH_STAGES[mesh]
    want = jax_ref["grads"]
    runs = [out["grad_" + name] for out in ranks]
    full_stack = sum(v.nbytes for k, v in want.items()
                     if k.startswith("encoder.layers."))
    for run in runs:
        assert run["training"], "the caller's mode is restored"
        assert run["calls"] == m * LAYERS // s
        assert run["stack_bytes"] * s == full_stack
    for lo in range(0, 4, s):  # each pipe group of s ranks
        group = runs[lo:lo + s]
        merged = {}
        for run in group:
            for k, g in run["grads"].items():
                if k.startswith("encoder.layers."):
                    assert k not in merged, f"{k} held twice"
                    merged[k] = g
                else:  # whole on every rank, and the same
                    np.testing.assert_array_equal(g, group[0]["grads"][k],
                                                  err_msg=k)
                    merged[k] = g
        assert set(merged) <= set(want)
        for k, w in want.items():
            if k not in merged:  # never reached in the forward
                assert not w.any(), k
                continue
            np.testing.assert_allclose(merged[k], w, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", ["ragged_groups", "bad_shapes",
                                  "model_axis"])
def test_pipe_refusals(ranks, jax_ref, case):
    """``ValueError``s before any hand-off, the JAX package's texts (its
    tests' ``match=``); the model axis's is the port's own."""
    names = {"ragged_groups": ["ragged_groups"],
             "bad_shapes": ["microbatches", "stages"],
             "model_axis": ["model_axis"]}[case]
    match = {"ragged_groups": "divisible by stages",
             "microbatches": "microbatches", "stages": "stages",
             "model_axis": "tensor parallelism"}
    for name in names:
        for r, out in enumerate(ranks):
            if name == "stages" and r == 3:
                continue  # the three-stage mesh holds ranks 0-2
            kind, text = out[name]
            assert kind == "ValueError" and match[name] in text, text
            if name in jax_ref["refusals"]:
                assert (kind, text) == jax_ref["refusals"][name]


def test_stack_roundtrip(setup):
    sd = {"wav2vec2." + k: v for k, v in setup["sd"].items()}
    stacked, rest = tpipe.split_layer_params(sd)
    assert not any(".layers." in k for k in rest)
    assert "wav2vec2.feature_projection.projection.weight" in rest
    for v in stacked.values():
        assert v.shape[0] == LAYERS
    back = tpipe.unstack_layer_params(stacked, "wav2vec2.encoder.layers.")
    assert set(back) | set(rest) == set(sd)
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    # the JAX stacking of the same weights, leaf for leaf (taken apart on
    # the host: one eager JAX op a leaf and layer costs seconds)
    jstacked = jax.tree.map(np.asarray,
                            jpipe.split_layer_params(setup["params"])[0])
    from_jax = encoder_state_dict_from_jax({
        **{f"layers_{i}": jax.tree.map(lambda x, i=i: x[i], jstacked)
           for i in range(LAYERS)}, **{
            k: v for k, v in setup["params"].items()
            if not k.startswith("layers_")}})
    for k, v in tpipe.unstack_layer_params(
            tpipe.split_layer_params(from_jax)[0]).items():
        torch.testing.assert_close(v, setup["sd"][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="non-contiguous"):
        tpipe.split_layer_params({k: v for k, v in setup["sd"].items()
                                  if not k.startswith("encoder.layers.1.")})
    # a placed model keeps only its stage's layers, by their own names
    model = Wav2Vec2Model(tcfg.tiny_config(**CFG))
    mesh = type("Mesh", (), {"mesh_dim_names": ("pipe",),
                             "size": lambda self, d: 2,
                             "get_local_rank": lambda self, a: 1})()
    assert tpipe.place_stage(model, mesh, interleave=2) == [1, 3]
    assert {k.split(".")[2] for k in model.state_dict()
            if k.startswith("encoder.layers.")} == {"1", "3"}
    with pytest.raises(ValueError, match="another pipe layout"):
        tpipe.place_stage(model, mesh)


def test_interleaved_layer_order_and_ticks():
    for n, s, v in ((24, 4, 2), (24, 4, 1), (4, 2, 2), (24, 2, 3), (4, 4, 1)):
        assert (tpipe.interleaved_layer_order(n, s, v)
                == jpipe.interleaved_layer_order(n, s, v))
    for args in ((24, 4, 5), (4, 3, 1)):
        with pytest.raises(ValueError, match="divisible") as e:
            tpipe.interleaved_layer_order(*args)
        with pytest.raises(ValueError) as j:
            jpipe.interleaved_layer_order(*args)
        assert str(e.value) == str(j.value)
    for m, s, v in ((8, 4, 1), (8, 4, 2), (4, 2, 2), (2, 1, 1)):
        assert tpipe.schedule_ticks(m, s, v) == jpipe.schedule_ticks(m, s, v)
