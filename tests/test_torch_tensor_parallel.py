"""aptai_tpu_torch's model axis (tensor and sequence parallelism) against
the JAX package, on the CPU:

* the placement table (``parallel.mesh.param_specs``) against the JAX
  package's ``param_shardings`` on a 4 × 2 mesh, for the default,
  ``fused_qkv`` and ``"bthd"`` encoders, with and without FSDP;
* four gloo ranks on a DP2×TP2 mesh (one spawn, ``_torch_parallel_worker.
  py``, importing the port only): two SGD steps under TP (DDP over the
  data axis), TP with FSDP, and TP with sequence parallelism, each
  against the JAX package's single-device step on the whole batch with
  ``tests/test_parallel.py``'s tolerance (loss within 1e-5; parameters
  ``rtol=2e-3, atol=1e-6``), and the forward through an
  ``APTAIPredictor`` on the mesh against the JAX predictor within 1e-5 of
  the largest magnitude.

The JAX side needs no mesh: the model axis is a single device's numerics.
Dropout is off in the parity steps (``tests/test_torch_tensor_parallel_
serving.py`` pins its draws). The batch's items have different lengths,
and T (119 frames) is odd, so the time shards of sequence parallelism
take a pad frame.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch.distributed.tensor import Replicate, Shard

from aptai_tpu.infer import APTAIPredictor as JaxAPTAIPredictor
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.parallel import make_mesh as jax_make_mesh
from aptai_tpu.parallel import param_shardings
from aptai_tpu.train import create_train_state, make_train_step
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.aptai import APTAI
from aptai_tpu_torch.models.convert import state_dict_from_jax
from aptai_tpu_torch.parallel import mesh as tmesh

import _torch_parallel_worker as worker
from _torch_port import (NO_DROP, one_torch_thread, random_jax_aptai_params)
from test_torch_parallel import ZERO_GRAD, _batch

NUM_PHN = worker.NUM_PHN
DET = dict(NO_DROP, mask_time_prob=0.0)
HEADS_OFF = dict(tv_drop=0.0, phn_drop=0.0)
LR = 1e-3
# the placement table's config: distinct widths, so that a transposed
# dimension shows (hidden 64 in 4 heads, FFN 128, conv 48)
WIDE = dict(hidden_size=64, intermediate_size=128, conv_dim=(48,) * 3,
            num_conv_pos_embedding_groups=4)
LAYOUTS = {"default": {}, "fused_qkv": {"fused_qkv": True},
           "bthd": {"attention_layout": "bthd"}}
FSDP_MIN = 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def setup():
    cfg_t = tcfg.tiny_config(**DET)
    params = random_jax_aptai_params(cfg_t, NUM_PHN, seed=11)
    rng = np.random.default_rng(21)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 9_000, 12_500, 4_000)]
    return {"params": params, "batch": _batch(cfg_t), "wavs": wavs,
            "sd": state_dict_from_jax(params)}


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """The four ranks, started once for the module."""
    inp = {"det": DET, **{k: setup[k] for k in ("sd", "batch", "wavs")}}
    return worker.start("tensor_steps", inp,
                        tmp_path_factory.mktemp("ranks"), world=4)


@pytest.fixture(scope="module")
def jax_ref(setup, spawned):
    """The JAX package's two single-device SGD steps on the whole batch
    and its predictor's outputs (computed while the ranks run)."""
    jmodel = JaxAPTAI(jcfg.tiny_config(**DET), num_phonemes=NUM_PHN,
                      **HEADS_OFF)

    def loss_fn(p, b, rngs=None):
        out = jmodel.apply({"params": p}, b["audio"], b["audio_lengths"],
                           b["phn_frames"], b["tv_targets"],
                           deterministic=False, rngs=rngs)
        return out["loss"], {}

    step = make_train_step(loss_fn, optax.identity())
    state = create_train_state(jax.tree.map(jnp.array, setup["params"]),
                               optax.identity())
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    for _ in range(2):
        state, m = step(state, jb, jax.random.PRNGKey(0), jnp.float32(LR))
    predict = JaxAPTAIPredictor(jmodel, jax.tree.map(
        jnp.asarray, setup["params"])).predict_batch(setup["wavs"])
    return {"loss": float(m["loss"]),
            "params": state_dict_from_jax(jax.tree.map(np.asarray,
                                                       state.params)),
            "predict": {k: np.asarray(v) for k, v in predict.items()}}


@pytest.fixture(scope="module")
def ranks(spawned, jax_ref):
    return worker.finish(spawned)


def _dims(params):
    """``{port name: (port dim of each JAX dim)}`` of a JAX tree: each leaf
    filled with its flat indices (offset per leaf) and crossed through
    the bridge, each port dimension's unit step reads the JAX stride it
    stands for."""
    leaves, treedef = jax.tree.flatten(params)
    offsets = np.cumsum([0] + [x.size for x in leaves])
    probe = jax.tree.unflatten(treedef, [
        (np.arange(x.size, dtype=np.float64) + o).reshape(x.shape)
        .astype(np.float32) for x, o in zip(leaves, offsets)])
    out = {}
    for name, t in state_dict_from_jax(probe).items():
        t = t.double()
        i = int(np.searchsorted(offsets, float(t.flatten()[0]),
                                side="right")) - 1
        shape = leaves[i].shape
        strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
        origin = t[(0,) * t.dim()]
        perm = []
        for j in range(t.dim()):
            if t.shape[j] == 1:
                perm.append(None)
                continue
            step = int(t[tuple(1 if k == j else 0 for k in range(t.dim()))]
                       - origin)
            perm.append(strides.index(step))
        out[name] = (i, perm)
    return leaves, out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_placement_table_matches_jax_param_shardings(layout):
    """``param_specs`` of the port's model names, per dimension, the axis
    ``param_shardings`` gives the JAX leaf that dimension comes from, on
    a 4 × 2 mesh, with and without FSDP (a floor of 1024 elements, so
    that both replicated and split leaves show)."""
    cfg_t = tcfg.tiny_config(**DET, **WIDE, **LAYOUTS[layout])
    params = random_jax_aptai_params(cfg_t, NUM_PHN, seed=3)
    model = APTAI(cfg_t, num_phonemes=NUM_PHN)
    mesh = jax_make_mesh(data=4, model=2)
    leaves, dims = _dims(params)
    assert set(dims) == {n for n, _ in model.named_parameters()}
    split = 0
    for fsdp in (False, True):
        want = jax.tree.leaves(param_shardings(mesh, params, fsdp=fsdp,
                                               fsdp_min_size=FSDP_MIN))
        got = tmesh.param_specs(model, data=4, fsdp=fsdp,
                                fsdp_min_size=FSDP_MIN)
        for name, (i, perm) in dims.items():
            spec = tuple(want[i].spec) + (None,) * (leaves[i].ndim
                                                    - len(want[i].spec))
            mine = tuple(spec[d] if d is not None else None for d in perm)
            assert got[name] == mine, (name, got[name], spec, perm)
            split += tmesh.MODEL_AXIS in mine
    # a layer's q, k, v (weights and biases), the output projection's
    # weight and the FFN's three; the fused q/k/v product stays whole
    per_layer = 4 if layout == "fused_qkv" else 10
    assert split == 2 * cfg_t.num_hidden_layers * per_layer
    # replicated() and batch_sharding() as DTensor placements on a 2-D mesh
    two_d = types.SimpleNamespace(ndim=2)
    assert tmesh.replicated(two_d) == (Replicate(), Replicate())
    assert tmesh.batch_sharding(two_d) == (Shard(0), Replicate())


def _assert_matches(got, want, steps):
    assert abs(got["loss"] - want["loss"]) < 1e-5, (got["loss"],
                                                   want["loss"])
    for name, w in want["params"].items():
        g = got["params"][name]
        if name.endswith(ZERO_GRAD):
            assert (g - w).abs().max() <= 2 * LR * steps, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)


def test_tp_steps_match_jax_single_device_step(ranks, jax_ref):
    """Two SGD steps on the DP2×TP2 mesh, the model axis splitting q, k, v,
    the output projection and the FFN, DDP over the data axis; each rank
    on its data index's two rows, against two JAX steps on the four."""
    for out in ranks:
        _assert_matches(out["tp"], jax_ref, steps=2)


def test_tp_fsdp_steps_match_jax_single_device_step(ranks, jax_ref):
    """The same two steps with FSDP over the data axis of the TP slices."""
    for out in ranks:
        _assert_matches(out["tp_fsdp"], jax_ref, steps=2)


def test_tp_sp_steps_match_jax_single_device_step(ranks, jax_ref):
    """The same two steps with ``activation_partition=("data", "model",
    None)``: the residual stream split over time between the sublayers,
    each sublayer's all-reduce a reduce-scatter plus an all-gather."""
    for out in ranks:
        _assert_matches(out["tp_sp"], jax_ref, steps=2)


def test_each_rank_holds_its_shards(ranks, setup):
    """Under TP each rank holds half of every split parameter and of its
    two Adam moments, the rest whole (the moments of the parameters that
    get a gradient, and a float32 step count each); FSDP then halves what
    it holds."""
    model = APTAI(tcfg.tiny_config(**DET), num_phonemes=NUM_PHN)
    dims = tmesh.model_parallel_dims(model)
    frozen = set(tmesh.frozen_parameter_names(model))

    def local(named):
        return sum(p.numel() * 4 // (2 if n in dims else 1)
                   for n, p in named)

    trained = [(n, p) for n, p in model.named_parameters()
               if n not in frozen]
    for out in ranks:
        tp = out["bytes"]["tp"]
        assert tp["params"] == local(model.named_parameters())
        assert tp["adam"] == 2 * local(trained) + 4 * len(trained)
        fsdp = out["bytes"]["tp_fsdp"]
        assert fsdp["params"] <= 0.55 * tp["params"]
        assert fsdp["adam"] <= 0.55 * tp["adam"]


def test_dp_tp_sp_predictor_matches_jax(ranks, jax_ref):
    """``APTAIPredictor(mesh=)`` on the DP2×TP2 mesh with sequence
    parallelism: every rank returns the whole batch's outputs, within
    1e-5 of the largest magnitude of the JAX predictor's; the kernels saw
    two of the four heads."""
    want = jax_ref["predict"]
    lengths = want["frame_lengths"]
    for out in ranks:
        assert out["heads"] == 2
        got = out["predict"]
        assert set(got) == set(want)
        for k, w in want.items():
            g = np.asarray(got[k])
            assert g.shape == w.shape, k
            if np.issubdtype(w.dtype, np.integer):
                for b, n in enumerate(lengths):
                    np.testing.assert_array_equal(g[b, :n] if g.ndim > 1
                                                  else g[b], w[b, :n]
                                                  if w.ndim > 1 else w[b],
                                                  err_msg=k)
                continue
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


def test_children_import_only_the_port(ranks):
    assert [out["jax_loaded"] for out in ranks] == [False] * 4
