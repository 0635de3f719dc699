"""aptai_tpu_torch's pretraining over two gloo ranks on the CPU (one spawn,
``_torch_parallel_worker.py``, importing the port only), against the JAX
package's single-device pretraining step on the global batch and against
one process of the port:

* two Adam steps on a (2, 1) mesh under DDP and under FSDP, and on a
  (1, 2) model axis, each rank on its rows of the global batch and of the
  draws the JAX step takes (span mask, Gumbel noise, distractors): the
  first step's loss and terms within 1e-5 relative (``test_torch_pretrain.
  py``'s gate), the second's within 1e-4 (``test_torch_pretrain_runs.
  py``'s gate after Adam steps, see below), every rank's perplexity and
  masked-frame count the global batch's, the parameters within
  ``tests/test_parallel.py``'s tolerance.
  The two ranks' masks are uneven (rank 0 masks about 70 % of its frames,
  rank 1 about 20 %), so a per-rank mean or codebook usage would fail;
* the quantizer placed as ``param_specs`` places it;
* the span mask, Gumbel noise and distractors two ranks draw from one seed,
  concatenated, bit for bit one process's, and a step of the real adapter
  on those draws equal to one process's step;
* ``global_total``: its value and DDP-averaged gradient one process's;
* ``pretrain.run`` on two ranks under DDP, ``--fsdp`` and ``--mesh_model
  2``: rank 0 alone writes, and its checkpoint and metrics equal a
  one-process run's.

Dropout is off in every parity step: each rank draws its own rows' dropout
masks. Adam's first step moves every parameter by the learning rate
whatever its gradient's size, so a gradient that is zero but for roundoff
(the key projection's bias: softmax ignores a shift shared by a row's
logits) may move either way on either side; it is held to twice the
learning rate a step instead, and the loss after such a step to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aptai_tpu.models import pretrain as jpre_model
from aptai_tpu_torch.data import make_synthetic_commonphone
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import pretrain as tpre
from aptai_tpu_torch.models.convert import pretrain_state_dict_from_jax
from aptai_tpu_torch.models.pretrain import negative_indices_from_uniform
from aptai_tpu_torch.models.wav2vec2 import compute_time_mask
from aptai_tpu_torch.parallel.global_batch import global_total
from aptai_tpu_torch.parallel.mesh import param_specs
from aptai_tpu_torch.train import TrainStep
from aptai_tpu_torch.train import pretrain as tpretrain
from aptai_tpu_torch.train.checkpoints import read_params

import _torch_parallel_worker as worker
from _torch_port import one_torch_thread
from _torch_pretrain_tiny import (HEAD, LOSS_REL, TINY, _rel_close,
                                  jax_model, random_jax_params)

LR = 1e-3
STEPS = 2
ADAM_EPS = 1e-6
ZERO_GRAD = "attention.k_proj.bias"
TERMS = ("loss", "contrastive_loss", "diversity_loss", "feature_penalty")
AFTER_ADAM_REL = 1e-5
RUNS = {"dp": {}, "fsdp": {"fsdp": True}, "tp": {"mesh_model": 2}}
RUN_LR = 1e-4  # the schedule holds 10x this after its warmup
RUN_CFG = dict(num_epochs=2, num_warmup_epochs=1, num_static_epochs=1,
               batch_size=4, learning_rate=RUN_LR, codevector_vars=64,
               codevector_dim=16, proj_codevector_dim=16, num_negatives=5,
               mask_prob=0.5, mask_span=4, mask_min_masks=1, platform="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _batch(cfg_t, seed=40):
    """Four rows of different lengths and their draws; the first two rows
    (rank 0's) mask about 70 % of their frames, the last two 20 %."""
    rng = np.random.default_rng(seed)
    n = 8000
    lens = np.array([8000, 6100, 7400, 4300], np.int32)
    audio = (rng.standard_normal((4, n)) * 0.1).astype(np.float32)
    for i, k in enumerate(lens):
        audio[i, k:] = 0.0
    t = int(cfg_t.feat_extract_output_lengths(n))
    frames = cfg_t.feat_extract_output_lengths(lens)
    mask = rng.random((4, t)) < np.array([0.7, 0.7, 0.2, 0.2])[:, None]
    u = rng.random((4, t, HEAD["num_negatives"]), np.float32)
    noise = rng.gumbel(size=(4, t, 2, HEAD["num_vars"]))
    # one code per frame and group ahead by far, so the straight-through
    # sample's argmax stays where it is while the steps move the logits,
    # and no two frames of an utterance on the same pair of codes, so no
    # distractor is decided a collision by roundoff (``isclose``)
    v = HEAD["num_vars"]
    pairs = np.stack([rng.permutation(v * v)[:t] for _ in range(4)])
    code = np.stack([pairs // v, pairs % v], axis=-1)
    np.put_along_axis(noise, code[..., None], 30.0, axis=-1)
    return {"audio": audio, "audio_lengths": lens,
            "gumbel_temp": np.full(4, 1.5, np.float32), "time_mask": mask,
            "gumbel_noise": noise.astype(np.float32),
            "negative_indices": negative_indices_from_uniform(
                torch.from_numpy(u), torch.from_numpy(frames)).numpy()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_ranks")
    cfg_t = tcfg.tiny_config(**TINY)
    torch.manual_seed(0)  # the codevectors' construction draws
    params = random_jax_params(cfg_t, 31)
    batch = _batch(cfg_t)
    t = batch["time_mask"].shape[1]
    draws = {"seed": 9, "t": t, "v": HEAD["num_vars"],
             "k": HEAD["num_negatives"], "mask": (0.5, 4, 1),
             "frames": cfg_t.feat_extract_output_lengths(
                 batch["audio_lengths"]).astype(np.int32)}
    rng = np.random.default_rng(41)
    inp = {"cfg": TINY, "head": HEAD, "lr": LR, "adam_eps": ADAM_EPS,
           "batch": batch,
           "sd": pretrain_state_dict_from_jax(params), "draws": draws,
           "rows": rng.standard_normal((4, 3)).astype(np.float32),
           "w": rng.standard_normal(3).astype(np.float32),
           "root": str(root / "runs"), "runs": RUNS,
           "run_cfg": dict(RUN_CFG, audio_csv_path=str(
               make_synthetic_commonphone(root / "cp", 6, 2, 2)))}
    return {"inp": inp, "params": params, "root": root, "cfg_t": cfg_t}


@pytest.fixture(scope="module")
def spawned(setup):
    return worker.start("pretrain_parallel", setup["inp"],
                        setup["root"] / "work")


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    """The JAX package's single-device pretraining step, two Adam steps on
    the global batch and its draws, in one compiled program: each step's
    outputs and the parameters after them."""
    b = setup["inp"]["batch"]
    jm = jax_model()
    opt = optax.adam(LR, eps=ADAM_EPS)

    def loss(p):
        out = jm.apply({"params": p}, b["audio"], b["audio_lengths"],
                       b["time_mask"], jnp.float32(1.5),
                       deterministic=False,
                       rngs={"gumbel": jax.random.PRNGKey(1),
                             "negatives": jax.random.PRNGKey(2),
                             "dropout": jax.random.PRNGKey(3)})
        return out["loss"], out

    def steps(p):
        state, outs = opt.init(p), []
        for _ in range(STEPS):
            (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
            updates, state = opt.update(g, state, p)
            p = optax.apply_updates(p, updates)
            outs.append(out)
        return p, outs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, dtype:
                   jnp.asarray(b["gumbel_noise"]))
        mp.setattr(jpre_model, "sample_negative_indices",
                   lambda *a: jnp.asarray(b["negative_indices"]))
        p, outs = jax.device_get(jax.jit(steps)(setup["params"]))
    return ({k: v.numpy() for k, v in pretrain_state_dict_from_jax(
        p).items()}, [{k: np.asarray(v) for k, v in o.items()}
                      for o in outs])


@pytest.fixture(scope="module")
def one_process(setup, spawned):
    """The port in one process: the draws and the adapter's step on the
    whole batch, ``global_total``'s function, and ``pretrain.run``."""
    inp = setup["inp"]
    d = inp["draws"]
    gen = torch.Generator().manual_seed(d["seed"])
    frames = torch.from_numpy(d["frames"])
    b = len(frames)
    draws = {"mask": compute_time_mask(gen, frames, d["t"], *d["mask"]),
             "noise": tpre.gumbel_noise((b, d["t"], 2, d["v"]), gen, "cpu"),
             "idx": tpre.sample_negative_indices(gen, b, d["t"], frames,
                                                 d["k"])}
    model = worker.pretrain_model(inp)
    step = TrainStep(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                     tpretrain.pretrain_loss_fn(0.5, 4, 1), device="cpu",
                     seed=3)
    metrics = step({k: inp["batch"][k] for k in (
        "audio", "audio_lengths", "gumbel_temp")}, 1e-2)
    w = torch.from_numpy(inp["w"]).requires_grad_()
    value = torch.log((global_total(
        (torch.from_numpy(inp["rows"]) * w).sum(0)) ** 2).sum())
    value.backward()
    exp = setup["root"] / "one"
    cfg = tpretrain.PretrainConfig(exp_dir=str(exp), **inp["run_cfg"]
                                   ).finalize("pretrain")
    history, _ = tpretrain.run(cfg, tcfg.tiny_config(**TINY))
    return {"draws": {k: v.numpy() for k, v in draws.items()},
            "step": {"metrics": {k: v.item() for k, v in metrics.items()},
                     "params": model.state_dict()},
            "total": {"value": value.item(), "grad": w.grad.numpy()},
            "history": history, "exp": exp}


@pytest.fixture(scope="module")
def ranks(spawned, jax_steps, one_process):
    return worker.finish(spawned, timeout=400)


def _params_close(got, want, steps=STEPS, lr=LR):
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        if name.endswith(ZERO_GRAD):
            assert np.abs(g - w).max() <= 2 * lr * steps, name
            continue
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("layout", ["dp", "fsdp", "tp"])
def test_step_matches_the_jax_single_device_step(ranks, jax_steps, layout):
    """Each step's loss and terms (the ranks' mean) and the parameters after
    two Adam steps against the JAX step on the global batch."""
    want_params, want = jax_steps
    outs = [r[layout] for r in ranks]
    for s in range(STEPS):
        rel = LOSS_REL if s == 0 else AFTER_ADAM_REL
        for k in TERMS:
            got = np.mean([o["seen"][s][k] for o in outs])
            _rel_close(float(got), float(want[s][k]), (layout, s, k),
                       rel=rel)
        got_acc = np.mean([o["seen"][s]["contrastive_accuracy"]
                           for o in outs])
        assert got_acc == pytest.approx(
            float(want[s]["contrastive_accuracy"]), abs=1e-6)
    for o in outs:
        _params_close({k: v.numpy() for k, v in o["params"].items()},
                      want_params)


def test_every_rank_holds_the_global_batchs_quantities(ranks, jax_steps):
    """The perplexity (a nonlinear function of the codebook usage) and the
    masked-frame count are the global batch's on each rank, not their
    mean; each rank's contrastive loss is its share of the global mean,
    which its own rows' mean is not (the masks are uneven)."""
    want = jax_steps[1]
    for s in range(STEPS):
        for r in ranks:
            seen = r["dp"]["seen"][s]
            _rel_close(float(seen["codebook_perplexity"]),
                       float(want[s]["codebook_perplexity"]),
                       "perplexity",
                       rel=LOSS_REL if s == 0 else AFTER_ADAM_REL)
            assert int(seen["num_masked"]) == int(want[s]["num_masked"])
    per_rank = [r["dp"]["seen"][0]["contrastive_loss"] for r in ranks]
    assert abs(per_rank[0] - per_rank[1]) > 1e-3 * abs(np.mean(per_rank))


def test_quantizer_placed_as_param_specs_places_it(ranks, setup):
    """FSDP shards ``codevectors`` and ``weight_proj`` on the dimensions of
    ``param_specs`` (a floor of 0 elements: every parameter split); the
    model axis leaves them whole on every rank."""
    model = worker.pretrain_model(setup["inp"])
    specs = param_specs(model, 2, fsdp=True, fsdp_min_size=0)
    full = dict(model.named_parameters())
    for r in ranks:
        for name, (kind, where) in r["fsdp"]["quantizer"].items():
            assert kind == "shard"
            assert specs[f"quantizer.{name}"].index("data") == where, name
        for name, (kind, shape) in r["tp"]["quantizer"].items():
            assert kind == "whole"
            assert shape == tuple(full[f"quantizer.{name}"].shape)
            assert param_specs(model, 1)[f"quantizer.{name}"] == \
                (None,) * len(shape)


def test_two_ranks_draw_what_one_process_draws(ranks, one_process):
    """The span mask, Gumbel noise and distractors two ranks draw from one
    seed, concatenated, bit for bit one process's on the whole batch."""
    want = one_process["draws"]
    for k, w in want.items():
        got = np.concatenate([r["draws"][k] for r in ranks])
        np.testing.assert_array_equal(got, w, err_msg=k)


def test_adapter_step_on_its_own_draws_matches_one_process(ranks,
                                                           one_process):
    """A step of ``pretrain_loss_fn`` drawing from the step's generator:
    the two ranks' metrics and parameters are one process's."""
    want = one_process["step"]
    for r in ranks:
        got = r["draws"]["step"]
        for k, w in want["metrics"].items():
            _rel_close(got["metrics"][k], w, k, rel=LOSS_REL)
        _params_close({k: v.numpy() for k, v in got["params"].items()},
                      {k: v.numpy() for k, v in want["params"].items()},
                      steps=1, lr=1e-2)


def test_global_total_value_and_averaged_gradient(ranks, one_process):
    want = one_process["total"]
    for r in ranks:
        assert r["total"]["value"] == pytest.approx(want["value"], rel=1e-6)
        np.testing.assert_allclose(r["total"]["grad"], want["grad"],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", list(RUNS))
def test_run_on_two_ranks_matches_one_process(ranks, one_process, setup,
                                              layout):
    """``pretrain.run``: rank 0's best checkpoint and each epoch's train
    loss and validation metrics against the one-process run's. Both draw
    their own Gumbel noise, so a straight-through argmax near a tie may
    go either way after a step, and Adam turns the roundoff of a gradient
    near zero into a step of the learning rate either way. The parameters,
    six Adam steps in, are held together to 1e-4 relative L2, and each
    entry to the most two such steps a step can part them (10x the base
    LR each)."""
    exp = setup["root"] / "runs" / layout
    got = read_params(exp / "best-model-ckpt")
    want = read_params(one_process["exp"] / "best-model-ckpt")
    assert set(got) == set(want)
    steps = sum(e["train_steps"] for e in one_process["history"])
    for k, w in want.items():
        assert (got[k] - w).abs().max() <= 2 * 10 * RUN_LR * steps, k
    a = torch.cat([got[k].double().ravel() for k in want])
    b = torch.cat([w.double().ravel() for w in want.values()])
    assert (a - b).norm() <= 1e-4 * b.norm()
    for r in ranks:
        hist = r["runs"][layout]["history"]
        assert len(hist) == len(one_process["history"]) == 2
        for g, w in zip(hist, one_process["history"]):
            assert g["train_steps"] == w["train_steps"] == 3
            for k in ("mean_train_loss",) + tuple(
                    f"val_{k}" for k in tpretrain.VAL_KEYS):
                _rel_close(g[k], w[k], (layout, k), rel=1e-4)


def test_only_rank_0_writes(ranks, setup):
    r0, r1 = (r["runs"] for r in ranks)
    for layout in RUNS:
        assert r1[layout]["writes"] == []
        wrote = {p.split(f"/{layout}/", 1)[1] for p in r0[layout]["writes"]}
        assert {"experiment_args.json", "metrics.jsonl"} <= wrote
        assert any(p.startswith("best-model-ckpt/") for p in wrote)
        assert r0[layout]["cfg"]["fsdp"] == RUNS[layout].get("fsdp", False)


def test_children_import_only_the_port(ranks):
    assert [r["jax_loaded"] for r in ranks] == [False, False]
