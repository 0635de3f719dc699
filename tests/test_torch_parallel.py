"""aptai_tpu_torch's data axis over ``torch.distributed`` against the JAX
package, on the CPU: the launch helpers (``parallel/multihost.py``) and
the mesh rule (``parallel/mesh.py``) against their JAX counterparts, then
two gloo ranks (one spawn, ``_torch_parallel_worker.py``, importing the
port only) whose DDP and FSDP train steps on their rows of a global batch
match the JAX package's single-device step on the whole batch with
``tests/test_parallel.py``'s tolerance (loss within 1e-5; parameters
``rtol=2e-3, atol=1e-6``). The batch's items have different lengths, so
the masked means of APTAI's loss must be the global batch's.

Dropout is off in every parity step: each rank draws its own rows'
dropout masks. SpecAugment's spans are drawn for the global batch and
sliced, so a DP step with SpecAugment on equals the port's single-device
step (the JAX package draws other spans, so that one is held to the
port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.parallel import mesh as jmesh
from aptai_tpu.parallel import multihost as jmultihost
from aptai_tpu.train import create_train_state, make_train_step
from aptai_tpu_torch.data.batching import BucketedLoader
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import (state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.parallel import mesh as tmesh
from aptai_tpu_torch.parallel import multihost as tmultihost
from aptai_tpu_torch.train import TrainStep
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn
from aptai_tpu_torch.train.train_pr import pr_loss_fn

import _torch_parallel_worker as worker
from _torch_port import (NO_DROP, one_torch_thread, random_jax_aptai_params,
                         random_jax_w2v2_pr_params)

NUM_PHN = worker.NUM_PHN
DET = dict(NO_DROP, mask_time_prob=0.0)
MASKED = dict(NO_DROP, mask_time_prob=0.3)
CTC_SUM = dict(DET, final_dropout=0.0, ctc_loss_reduction="sum")
HEADS_OFF = dict(tv_drop=0.0, phn_drop=0.0)
LR = 1e-3
# rows of each rank's two grad_accum microbatches, in global-batch order:
# microbatch i of the DP step is row i of each rank's pair
ACCUM_ORDER = [0, 2, 1, 3]
# an exactly zero gradient (softmax is invariant to a shift shared by a
# row's logits): each side moves it by roundoff alone
ZERO_GRAD = "attention.k_proj.bias"
ENV = ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "RANK", "SLURM_NTASKS",
       "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE")


def _batch(cfg, seed=12):
    """Four items of different lengths: the two ranks' rows hold different
    numbers of valid frames."""
    rng = np.random.default_rng(seed)
    b, samples = 4, 2400
    lens = np.array([2400, 1700, 2100, 900], np.int32)
    audio = (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    t = int(cfg.feat_extract_output_lengths(samples))
    phn = rng.integers(1, NUM_PHN, (b, t)).astype(np.int32)
    tv = rng.standard_normal((b, t, 9)).astype(np.float32)
    for i, n in enumerate(cfg.feat_extract_output_lengths(lens)):
        phn[i, n:] = 0
        tv[i, n:] = -100.0
    return {"audio": audio, "audio_lengths": lens, "phn_frames": phn,
            "tv_targets": tv}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _pr_batch(seed=13):
    """Four items of different lengths and label counts (CTC)."""
    rng = np.random.default_rng(seed)
    lens = np.array([3200, 2000, 2800, 1500], np.int32)
    audio = (rng.standard_normal((4, 3200)) * 0.1).astype(np.float32)
    labels = np.full((4, 6), -100, np.int32)
    for i, (n, k) in enumerate(zip(lens, (5, 2, 4, 3))):
        audio[i, n:] = 0.0
        labels[i, :k] = rng.integers(1, 11, k)
    return {"audio": audio, "audio_lengths": lens, "phoneme_labels": labels}


@pytest.fixture(scope="module")
def setup():
    cfg_t = tcfg.tiny_config(**DET)
    params = random_jax_aptai_params(cfg_t, NUM_PHN, seed=11)
    masked = random_jax_aptai_params(tcfg.tiny_config(**MASKED), NUM_PHN,
                                     seed=5)
    pr = random_jax_w2v2_pr_params(tcfg.tiny_config(**CTC_SUM), seed=7)
    return {"params": params, "batch": _batch(cfg_t),
            "sd": state_dict_from_jax(params),
            "sd_masked": state_dict_from_jax(masked),
            "sd_pr": w2v2_pr_state_dict_from_jax(pr), "pr_batch": _pr_batch()}


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """The two ranks, started once for the module."""
    inp = {"det": DET, "masked": MASKED, "ctc_sum": CTC_SUM,
           **{k: setup[k] for k in ("sd", "sd_masked", "batch", "sd_pr",
                                    "pr_batch")}}
    return worker.start("steps", inp, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def ranks(spawned, jax_steps):
    """The two ranks' results (the JAX reference runs while they do)."""
    return worker.finish(spawned)


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    """The JAX package's single-device SGD steps (``optax.identity``):
    two on the global batch, and one with ``grad_accum=2`` on it in the
    DP step's microbatch order."""
    jmodel = JaxAPTAI(jcfg.tiny_config(**DET), num_phonemes=NUM_PHN,
                      **HEADS_OFF)

    def loss_fn(p, b, rngs=None):
        out = jmodel.apply({"params": p}, b["audio"], b["audio_lengths"],
                           b["phn_frames"], b["tv_targets"],
                           deterministic=False, rngs=rngs)
        return out["loss"], {}

    def run(batch, n, grad_accum):
        step = make_train_step(loss_fn, optax.identity(),
                               grad_accum=grad_accum)
        state = create_train_state(jax.tree.map(jnp.array, setup["params"]),
                                   optax.identity())
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for _ in range(n):
            state, m = step(state, jb, jax.random.PRNGKey(0),
                            jnp.float32(LR))
        return float(m["loss"]), state_dict_from_jax(
            jax.tree.map(np.asarray, state.params))

    batch = setup["batch"]
    return {"two": run(batch, 2, 1),
            "accum": run({k: v[ACCUM_ORDER] for k, v in batch.items()}, 1,
                         2)}


def _assert_matches(got, want, steps):
    loss, params = want
    assert abs(got["loss"] - loss) < 1e-5, (got["loss"], loss)
    for name, w in params.items():
        g = got["params"][name]
        if name.endswith(ZERO_GRAD):
            assert (g - w).abs().max() <= 2 * LR * steps, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("env", [
    {},
    {"RANK": "1", "WORLD_SIZE": "4"},
    {"SLURM_PROCID": "3", "RANK": "0", "OMPI_COMM_WORLD_SIZE": "8",
     "WORLD_SIZE": "2"}])
def test_process_env_defaults_match_jax(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tmultihost.process_env_defaults() == \
        jmultihost.process_env_defaults()


def test_init_distributed_argument_errors_match_jax(monkeypatch):
    """The JAX function's returns and ``ValueError``s for the same
    arguments; the port's own checks (a rank past the size, ``"auto"``
    without the launch in the environment) raise before any group; one
    process is primary."""
    assert tmultihost.init_distributed("") is \
        jmultihost.init_distributed("") is False
    for args in ((0, 0), (2, -1), (-1, 3)):
        with pytest.raises(ValueError) as want:
            jmultihost.init_distributed("127.0.0.1:1", *args)
        with pytest.raises(ValueError) as got:
            tmultihost.init_distributed("127.0.0.1:1", *args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not below"):
        tmultihost.init_distributed("127.0.0.1:1", 2, 2)
    for k in ENV + ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="num_processes"):
        tmultihost.init_distributed("auto")
    assert not torch.distributed.is_initialized()
    assert tmultihost.is_primary() and tmultihost.process_count() == 1


def test_make_mesh_rule_and_errors_match_jax(monkeypatch):
    """``data=-1`` takes every process and the two ``ValueError``s are the
    JAX function's; the model axis and a mesh over part of the processes
    raise ``NotImplementedError`` (ROADMAP item 8e-ii); one process has no
    mesh to place on."""
    devices = jax.devices()[:4]
    monkeypatch.setattr(tmesh, "process_count", lambda: 4)
    for data, model in ((-1, 3), (8, 1), (3, 2)):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(data, model, devices=devices)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(data, model)
        assert str(got.value) == str(want.value)
    assert jmesh.make_mesh(-1, 1, devices=devices).shape["data"] == 4
    assert tmesh.make_mesh(-1, 1) is None  # no process group here
    jmesh.make_mesh(2, 2, devices=devices)
    with pytest.raises(NotImplementedError, match="8e-ii"):
        tmesh.make_mesh(2, 2)
    with pytest.raises(NotImplementedError, match="data=-1"):
        tmesh.make_mesh(2, 1)
    monkeypatch.setattr(tmesh, "process_count", lambda: 1)
    assert tmesh.make_mesh() is None


class _Mesh:
    """A stand-in for a DeviceMesh: the data axis's size and this rank."""

    def __init__(self, n, r):
        self.n, self.r = n, r

    def size(self):
        return self.n

    def get_local_rank(self, axis):
        assert axis == tmesh.DATA_AXIS
        return self.r


def test_shard_batch_takes_the_loaders_rows():
    """``shard_batch`` keeps the rows ``BucketedLoader(process_index=r,
    process_count=n)`` serves rank ``r``; a batch that does not divide
    raises; without a mesh the batch is whole."""
    items = [{"audio_len": 100, "x": np.full(3, i, np.float32)}
             for i in range(6)]

    def collate(rows):
        return {"x": np.stack([r["x"] for r in rows])}

    whole = next(iter(BucketedLoader(items, 6, collate, shuffle=False)))
    for r in range(3):
        part = next(iter(BucketedLoader(items, 6, collate, shuffle=False,
                                        process_index=r, process_count=3)))
        got = tmesh.shard_batch(_Mesh(3, r), whole)
        for k in part:
            np.testing.assert_array_equal(got[k], part[k])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(_Mesh(4, 0), whole)
    assert tmesh.shard_batch(None, whole) is whole


def test_dp_steps_match_jax_single_device_step(ranks, jax_steps):
    """Two SGD steps under ``DistributedDataParallel``, each rank on its
    two rows, against two JAX steps on the four; the frozen feature
    extractor is left out of DDP's buckets (a second step would raise
    otherwise) and stays as it was."""
    for out in ranks:
        _assert_matches(out["dp"], jax_steps["two"], steps=2)


def test_fsdp_steps_match_jax_single_device_step(ranks, jax_steps):
    """The same two steps with ``shard_tree(fsdp=True)``: each transformer
    layer a group (``fsdp_min_size=0``) and the root."""
    for out in ranks:
        _assert_matches(out["fsdp"], jax_steps["two"], steps=2)


def test_fsdp_shards_params_and_adam_state(ranks):
    """Under FSDP each rank holds about half the parameters and half the
    Adam state that DDP replicates (``tree_bytes`` counts the local
    shard), the two halves covering the whole."""
    dp = ranks[0]["bytes"]["dp"]
    assert all(out["bytes"]["dp"] == dp for out in ranks)
    for key in ("params", "adam"):
        local = [out["bytes"]["fsdp"][key] for out in ranks]
        assert max(local) <= 0.55 * dp[key], (key, local, dp[key])
        assert sum(local) >= dp[key]
    assert ranks[0]["fsdp"]["local_bytes"] <= 0.55 * \
        ranks[0]["dp"]["local_bytes"]


def test_dp_grad_accum_matches_jax(ranks, jax_steps):
    """``grad_accum=2`` under DDP: each rank splits its two rows, one
    all-reduce with the last microbatch (``no_sync`` before it). Against
    the JAX step with ``grad_accum=2`` on the batch in that microbatch
    order."""
    for out in ranks:
        _assert_matches(out["dp_accum"], jax_steps["accum"], steps=1)


def test_dp_specaugment_draws_the_global_batch_rows(setup, ranks):
    """With SpecAugment on, each rank draws the global batch's spans and
    keeps its rows: two DP steps equal the port's single-device steps."""
    model = worker.aptai(MASKED, setup["sd_masked"])
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=LR)
    step = TrainStep(model, opt, aptai_loss_fn(), device="cpu")
    for _ in range(2):
        m = step(setup["batch"], LR)
    want = model.state_dict()
    for out in ranks:
        got = out["dp_specaugment"]
        assert abs(got["loss"] - m["loss"].item()) < 1e-5
        for name, w in want.items():
            if name.endswith(ZERO_GRAD):
                continue
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=name)


def test_dp_ctc_sum_is_the_global_batchs_sum(setup, ranks):
    """W2V2PR with ``ctc_loss_reduction="sum"`` under DDP: each rank's sum
    counts as the global batch's (``global_sum``), so two DP steps equal
    the port's single-device steps on the four items."""
    got = worker.sgd_steps(worker.w2v2_pr(CTC_SUM, setup["sd_pr"]),
                           setup["pr_batch"], None, False,
                           loss_fn=pr_loss_fn())
    for out in ranks:
        dp = out["dp_ctc_sum"]
        assert abs(dp["loss"] - got["loss"]) <= 1e-5 * abs(got["loss"])
        for name, w in got["params"].items():
            if name.endswith(ZERO_GRAD):
                continue
            np.testing.assert_allclose(dp["params"][name].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=name)


def test_children_import_only_the_port(ranks):
    """The ranks ran without JAX or the JAX package, rank 0 primary."""
    assert [out["jax_loaded"] for out in ranks] == [False, False]
    assert [out["primary"] for out in ranks] == [True, False]
