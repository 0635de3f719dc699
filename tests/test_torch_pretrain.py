"""aptai_tpu_torch's wav2vec2 pretraining against the JAX package's, float32
on the CPU, tiny config (2 layers, the 7-layer conv stack at 16 channels):

* the weight bridge (``pretrain_state_dict_from_jax``) and the family it
  is read as (``any_state_dict_from_jax``);
* ``GumbelVectorQuantizer``, deterministic and with injected Gumbel noise:
  quantized vectors, perplexity with and without a position mask, and the
  gradients through the straight-through sample;
* the distractor indices against JAX's on the same uniforms, exactly,
  lengths 0, 1, 2 and T;
* the whole ``Wav2Vec2Pretrain``, in ``train()`` at V = 8 and in
  ``eval()`` at V = 2 with distractors equal to the positive (one frame's
  all of them): its eight outputs and the gradients of ``loss`` against
  ``jax.grad`` through the bridge (losses 1e-5 relative; each gradient
  1e-3 relative + 1e-5, all together relative L2 1e-4 and cosine
  1 − 1e-8);
* ``PretrainConfig``'s flags, ``PretrainAudioDataset``'s crops,
  ``collate_audio`` and ``GumbelTemperatureLoader`` against JAX's;
* ``pretrain.run`` for 2 epochs on a synthetic CommonPhone corpus, then
  its best checkpoint grafted into ``build_pr_model`` and
  ``build_aptai_model`` bit for bit;
* a JAX pretrain run preempted mid-epoch (made once per module): grafted
  by the port's builders, and resumed by the port's ``fit`` (params, Adam
  moments by name, step, watermark), the remaining epochs' losses and
  ``val_*`` metrics within 1e-4 of the JAX resume's. Flax's random streams
  cannot be reproduced in torch, so both sides take the same injected
  draws (the span mask, the Gumbel noise, the distractors), which also
  pins the validation forward's fixed generators (ROADMAP Queue 3).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import pretrain as jpre_model
from aptai_tpu.models.hf_convert import convert_wav2vec2_encoder
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train import config as jconfig
from aptai_tpu.train import harness as jharness
from aptai_tpu.train import loop as jloop
from aptai_tpu.train import pretrain as jpretrain
from aptai_tpu_torch.data import make_synthetic_commonphone
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import pretrain as tpre_model
from aptai_tpu_torch.models.convert import (any_state_dict_from_jax,
                                            pretrain_state_dict_from_jax)
from aptai_tpu_torch.models.pretrain import (GumbelVectorQuantizer,
                                             Wav2Vec2Pretrain,
                                             negative_indices_from_uniform,
                                             random_wav2vec2_pretrain,
                                             sample_negative_indices)
from aptai_tpu_torch.train import builders
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train import pretrain as tpretrain
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               load_flax_params, load_state)
from aptai_tpu_torch.train.harness import make_engine
from aptai_tpu_torch.train.loop import fit

from _torch_port import NO_DROP, _noisy_state_dict, one_torch_thread
from test_torch_trainers import (_PreemptingLoader, _assert_resumes_match,
                                 _port_restore_probe, _resume_jax_run)

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
TINY = dict(STACK, **NO_DROP, apply_spec_augment=True, mask_time_prob=0.0)
HEAD = dict(num_groups=2, num_vars=8, codevector_dim=16,
            proj_codevector_dim=16, num_negatives=10)
LOSS_REL = 1e-5
# (V, train): the straight-through path; collisions in eval
CASES = ((8, True), (2, False))
OUTPUTS = ("loss", "contrastive_loss", "diversity_loss", "feature_penalty",
           "codebook_perplexity", "contrastive_accuracy", "num_masked",
           "frame_lengths")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def jax_tree(sd, num_layers):
    """A port ``Wav2Vec2Pretrain`` state dict (numpy) → the JAX tree."""
    dense = lambda n: {"kernel": sd[f"{n}.weight"].T.copy(),
                       "bias": sd[f"{n}.bias"]}
    return {"encoder": convert_wav2vec2_encoder(sd, num_layers,
                                                prefix="wav2vec2."),
            "quantizer": {"codevectors": sd["quantizer.codevectors"],
                          "weight_proj": dense("quantizer.weight_proj")},
            "project_hid": dense("project_hid"),
            "project_q": dense("project_q")}


def random_jax_params(cfg_t, seed, **head):
    """The JAX tree of a port model with noisy random weights."""
    model = Wav2Vec2Pretrain(cfg_t, **{**HEAD, **head})
    return jax_tree(_noisy_state_dict(model, seed), cfg_t.num_hidden_layers)


def port_from_jax(cfg_t, params, **head):
    model = Wav2Vec2Pretrain(cfg_t, **{**HEAD, **head})
    model.load_state_dict(pretrain_state_dict_from_jax(params), strict=True)
    return model


def jax_model(**head):
    return jpre_model.Wav2Vec2Pretrain(jcfg.tiny_config(**TINY),
                                       **{**HEAD, **head})


def _rel_close(got, want, what, rel=LOSS_REL):
    assert abs(got - want) <= rel * max(abs(want), 1e-6), (what, got, want)


def _check_grads(model, want):
    """Each ``.grad`` against the bridged JAX gradient, and all together."""
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-5,
                                   err_msg=n)
    a = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    b = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 1 - 1e-8


# -- the bridge ---------------------------------------------------------------

def test_bridge_round_trips_and_is_read_as_pretrain():
    cfg_t = tcfg.tiny_config(**TINY)
    sd = _noisy_state_dict(Wav2Vec2Pretrain(cfg_t, **HEAD), 3)
    params = jax_tree(sd, cfg_t.num_hidden_layers)
    for got in (pretrain_state_dict_from_jax(params),
                any_state_dict_from_jax(params)):
        assert set(got) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- the quantizer ------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_quantizer_matches_jax(monkeypatch, train, use_mask):
    g, v, d, c = 2, 4, 8, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, c)).astype(np.float32)
    noise = rng.gumbel(size=(2, 6, g, v)).astype(np.float32)
    pos_mask = rng.random((2, 6)) < 0.5 if use_mask else None
    params = {"codevectors": rng.random((1, g * v, d // g), np.float32),
              "weight_proj": {
                  "kernel": rng.standard_normal((c, g * v)).astype(
                      np.float32),
                  "bias": 0.1 * rng.standard_normal(g * v).astype(
                      np.float32)}}
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype: jnp.asarray(noise))
    jq = jpre_model.GumbelVectorQuantizer(g, v, d)

    def jax_fn(p, x):
        qz, ppl = jq.apply({"params": p}, x, 0.7, not train,
                           pos_mask=pos_mask,
                           rngs={"gumbel": jax.random.PRNGKey(0)})
        return jnp.sum(qz ** 2) + ppl, (qz, ppl)

    (_, (jqz, jppl)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(params, x)

    tq = GumbelVectorQuantizer(c, g, v, d).train(train)
    tq.load_state_dict({
        "codevectors": torch.from_numpy(params["codevectors"]),
        "weight_proj.weight": torch.from_numpy(
            params["weight_proj"]["kernel"].T.copy()),
        "weight_proj.bias": torch.from_numpy(params["weight_proj"]["bias"])})
    xt = torch.from_numpy(x).requires_grad_()
    qz, ppl = tq(xt, 0.7, None if pos_mask is None
                 else torch.from_numpy(pos_mask), noise=torch.from_numpy(
                     noise))
    (qz.pow(2).sum() + ppl).backward()
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(jqz),
                               rtol=1e-6, atol=1e-6)
    _rel_close(ppl.item(), float(jppl), "perplexity")
    # float32 gradients of exp/log chains: the repo's per-tensor bound
    for got, want in ((xt.grad, jgx),
                      (tq.weight_proj.weight.grad,
                       np.asarray(jgp["weight_proj"]["kernel"]).T),
                      (tq.weight_proj.bias.grad, jgp["weight_proj"]["bias"]),
                      (tq.codevectors.grad, jgp["codevectors"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-5)
    if train:  # the straight-through path carries a gradient to the input
        assert np.abs(xt.grad.numpy()).max() > 0


# -- the distractors ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_negative_indices_match_jax_exactly(monkeypatch, seed):
    b, t, k = 4, 23, 12
    lengths = np.array([0, 1, 2, t], np.int32)
    u = np.random.default_rng(seed).random((b, t, k), np.float32)
    u[0, 0, :2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
    u[3, 5, :2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    want = np.asarray(jpre_model.sample_negative_indices(
        jax.random.PRNGKey(0), b, t, jnp.asarray(lengths), k))
    got = negative_indices_from_uniform(torch.from_numpy(u),
                                        torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    # the full-length item: every distractor valid and never the frame
    assert got[3].max() < t and not (got[3] == np.arange(t)[:, None]).any()
    drawn = sample_negative_indices(torch.Generator().manual_seed(seed), b,
                                    t, torch.from_numpy(lengths), k)
    assert drawn.shape == (b, t, k) and drawn.dtype == torch.int32
    assert int(drawn[3].max()) < t and int(drawn.min()) >= 0


# -- the whole model ----------------------------------------------------------

def _inputs(cfg_t, num_vars, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    audio[1, 5500:] = 0.0
    lens = np.array([8000, 5500], np.int32)
    t = int(cfg_t.feat_extract_output_lengths(8000))
    frames = cfg_t.feat_extract_output_lengths(lens)
    mask = rng.random((2, t)) < 0.5
    mask[0, 0] = True
    noise = rng.gumbel(size=(2, t, 2, num_vars)).astype(np.float32)
    u = rng.random((2, t, HEAD["num_negatives"]), np.float32)
    idx = negative_indices_from_uniform(torch.from_numpy(u),
                                        torch.from_numpy(frames)).numpy()
    return audio, lens, mask, noise, idx


def _collide_first_frame(model, audio, lens, mask, idx):
    """Point every distractor of item 0's frame 0 at frames with its exact
    codes (the argmax of the port's own quantizer logits), so that frame's
    logits are the positive and −∞ only."""
    with torch.no_grad():
        extract = model.wav2vec2(torch.from_numpy(audio),
                                 torch.from_numpy(lens),
                                 time_mask=torch.from_numpy(mask))[2]
        logits = model.quantizer.weight_proj(extract.float())
        logits = logits.view(*extract.shape[:2], 2, -1)
        codes = logits.argmax(-1)[0].numpy()  # (T, G)
    same = [j for j in range(1, len(codes))
            if (codes[j] == codes[0]).all()]
    assert same, "no frame shares frame 0's codes"
    idx = idx.copy()
    idx[0, 0] = np.resize(same, idx.shape[-1])
    return idx


@pytest.fixture(scope="module")
def model_cases():
    """Per case, the inputs, the port model holding the JAX weights, and the
    JAX forward's outputs and gradients, both cases in one jitted program
    (its compile is most of this module's time): V = 8 in ``train()``
    (Gumbel noise, the straight-through sample), and V = 2 in ``eval()``
    with distractors equal to the positive. The collisions are tested
    deterministically: in training the straight-through rows of one code
    differ by rounding (``hard + y_soft − y_soft``), and ``isclose``'s
    1e-8 absolute tolerance then decides entries near zero by that
    rounding, in either package."""
    cfg_t = tcfg.tiny_config(**TINY)
    cases, fns, trees = {}, [], []
    for v, train in CASES:
        params = random_jax_params(cfg_t, 5 + v, num_vars=v)
        model = port_from_jax(cfg_t, params, num_vars=v).train(train)
        audio, lens, mask, noise, idx = _inputs(cfg_t, v, seed=v)
        if not train:
            idx = _collide_first_frame(model, audio, lens, mask, idx)
        jm = jax_model(num_vars=v)

        def jax_fn(p, jm=jm, audio=audio, lens=lens, mask=mask, noise=noise,
                   idx=idx, train=train):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, "gumbel",
                           lambda key, shape, dtype: jnp.asarray(noise))
                mp.setattr(jpre_model, "sample_negative_indices",
                           lambda *a: jnp.asarray(idx))
                out = jm.apply({"params": p}, audio, lens, mask,
                               jnp.float32(1.5), deterministic=not train,
                               rngs={"gumbel": jax.random.PRNGKey(1),
                                     "negatives": jax.random.PRNGKey(2),
                                     "dropout": jax.random.PRNGKey(3)})
            return out["loss"], out

        cases[v] = (model, (audio, lens, mask, noise, idx))
        fns.append(jax.value_and_grad(jax_fn, has_aux=True))
        trees.append(params)
    results = jax.jit(lambda ps: [f(p) for f, p in zip(fns, ps)])(trees)
    for v, ((_, out), grads) in zip((v for v, _ in CASES), results):
        want = {k: np.asarray(o) for k, o in out.items()}
        want_g = {k: g.numpy() for k, g in pretrain_state_dict_from_jax(
            jax.tree.map(np.asarray, grads)).items()}
        cases[v] += (want, want_g)
    return cases


@pytest.mark.parametrize("num_vars", [v for v, _ in CASES],
                         ids=["train_v8", "eval_v2_collisions"])
def test_model_outputs_and_gradients_match_jax(model_cases, num_vars):
    model, (audio, lens, mask, noise, idx), want, want_g = model_cases[
        num_vars]
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(audio), torch.from_numpy(lens),
                torch.from_numpy(mask), 1.5,
                gumbel_noise=torch.from_numpy(noise),
                negative_indices=torch.from_numpy(idx))
    out["loss"].backward()
    assert set(out) == set(OUTPUTS) == set(want)
    for k in ("num_masked", "frame_lengths"):
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    for k in OUTPUTS[:5]:
        _rel_close(out[k].item(), float(want[k]), k)
    assert out["contrastive_accuracy"].item() == pytest.approx(
        float(want["contrastive_accuracy"]), abs=1e-7)
    assert 0.0 <= out["contrastive_accuracy"].item() <= 1.0
    assert 0.0 < out["codebook_perplexity"].item() <= 2 * num_vars
    _check_grads(model, want_g)
    # V = 2: item 0's frame 0 scores its positive against −∞ only, and
    # every gradient stays finite
    assert all(np.isfinite(p.grad.numpy()).all()
               for p in model.parameters() if p.grad is not None)


def test_model_refuses_a_config_without_the_mask_embedding():
    with pytest.raises(ValueError, match="apply_spec_augment"):
        Wav2Vec2Pretrain(tcfg.tiny_config(apply_spec_augment=False))


# -- the trainer's pieces -----------------------------------------------------

def test_pretrain_config_matches_jax(tmp_path):
    argv = ["--exp_dir", str(tmp_path / "run"), "--crop_seconds", "3.5",
            "--mask_prob", "0.5", "--codevector_vars", "64",
            "--gumbel_temp_decay", "0.9", "--laptop", "--platform", "cpu",
            "--mesh_data", "1"]
    got = dataclasses.asdict(tconfig.parse_config(
        tpretrain.PretrainConfig, "pretrain", argv))
    want = dataclasses.asdict(jconfig.parse_config(
        jpretrain.PretrainConfig, "pretrain", argv))
    assert got.pop("date_time") and want.pop("date_time")
    assert got == want
    assert (dataclasses.asdict(tpretrain.PretrainConfig())
            == dataclasses.asdict(jpretrain.PretrainConfig()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_commonphone(tmp_path_factory.mktemp("cp"), 6, 2, 2)


def test_dataset_and_collate_match_jax(corpus):
    rows = read_rows(corpus)
    got_ds = tpretrain.PretrainAudioDataset(rows, crop_seconds=1.0, seed=4)
    want_ds = jpretrain.PretrainAudioDataset(pd.read_csv(corpus),
                                             crop_seconds=1.0, seed=4)
    assert len(got_ds) == len(want_ds) == len(rows)
    items = [got_ds[i] for i in range(len(got_ds))]
    for i, item in enumerate(items):
        want = want_ds[i]
        assert item["audio_len"] == want["audio_len"] <= 16000
        np.testing.assert_array_equal(item["audio"], want["audio"])
    for bucket in (True, False):
        got = tpretrain.collate_audio(items[:3], bucket)
        want = jpretrain.collate_audio(items[:3], bucket)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    # HPRC manifests name the column path_wav
    hprc = [{"path_wav": r["path"], "path": None} for r in rows[:2]]
    assert tpretrain.PretrainAudioDataset(hprc).paths == [
        r["path"] for r in rows[:2]]


def test_gumbel_temperature_loader_matches_jax():
    batches = [{"audio": np.zeros((3, 4), np.float32),
                "audio_lengths": np.array([4, 3, 2], np.int32)}]
    got = tpretrain.GumbelTemperatureLoader(batches, 2.0, 0.5, 0.5)
    want = jpretrain.GumbelTemperatureLoader(batches, 2.0, 0.5, 0.5)
    assert len(got) == len(want) == 1
    for _ in range(4):
        assert got.temperature == want.temperature
        g, w = list(got), list(want)
        np.testing.assert_array_equal(g[0]["gumbel_temp"],
                                      w[0]["gumbel_temp"])
        assert g[0]["gumbel_temp"].dtype == np.float32
    assert got.temperature == 0.5  # the floor
    assert "gumbel_temp" not in batches[0]


# -- the trainer, then the graft ----------------------------------------------

@pytest.fixture(scope="module")
def port_run(corpus, tmp_path_factory):
    exp = tmp_path_factory.mktemp("pretrain") / "run"
    cfg = tpretrain.PretrainConfig(
        exp_dir=str(exp), audio_csv_path=str(corpus), num_epochs=2,
        num_warmup_epochs=1, num_static_epochs=1, batch_size=2,
        learning_rate=1e-3, codevector_vars=8, codevector_dim=16,
        proj_codevector_dim=16, num_negatives=5, platform="cpu",
    ).finalize("pretrain")
    history, model = tpretrain.run(
        cfg, tiny_backbone=tcfg.tiny_config(**STACK))
    return exp, history, model


def test_run_trains_and_checkpoints(port_run):
    exp, history, model = port_run
    assert [e["epoch"] for e in history] == [0, 1]
    for e in history:
        assert np.isfinite(e["mean_train_loss"])
        assert all(np.isfinite(e[f"val_{k}"]) for k in tpretrain.VAL_KEYS)
        assert 0.0 <= e["val_contrastive_accuracy"] <= 1.0
    for f in ("experiment_args.json", "metrics.jsonl",
              "best-model-ckpt/params.pt", "last-model-ckpt/opt_state.pt"):
        assert (exp / f).exists(), f
    cfg = json.loads((exp / "best-model-ckpt" / "model_cfg.json").read_text())
    assert cfg["kind"] == "w2v2_pretrain"
    assert cfg["backbone"]["apply_spec_augment"]
    assert cfg["quantizer"]["vars"] == 8
    # the model trained: its parameters left the seed's
    fresh = random_wav2vec2_pretrain(model.cfg, 0, num_vars=8,
                                     codevector_dim=16,
                                     proj_codevector_dim=16)
    assert not torch.equal(model.quantizer.codevectors,
                           fresh.quantizer.codevectors)


@pytest.mark.parametrize("build", ["build_pr_model", "build_aptai_model"])
def test_port_run_grafts_bit_for_bit(port_run, build, capsys):
    exp = port_run[0]
    best = load_state(exp / "best-model-ckpt" / "params.pt")
    cfg = tconfig.PRConfig(platform="cpu", pretrained_checkpoint=str(exp))
    model, _ = getattr(builders, build)(
        cfg, {f"p{i}": i for i in range(5)},
        tiny=tcfg.tiny_config(**STACK), seed=9)
    got = model.wav2vec2.state_dict()
    assert "masked_spec_embed" in got
    assert all(torch.equal(v, best[f"wav2vec2.{k}"]) for k, v in got.items())
    assert f": {len(got)} leaves spliced\n" in capsys.readouterr().out


def test_main_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpretrain.main(["--exp_dir", str(tmp_path / "r"),
                        "--audio_csv_path", str(tmp_path / "none.csv")])


# -- a JAX pretrain run -------------------------------------------------------

def _fixed_draws(b, t, v, k, seed=17):
    rng = np.random.default_rng(seed)
    frames = np.full(b, t, np.int32)
    frames[1] = t - 7
    u = rng.random((b, t, k), np.float32)
    return {"mask": rng.random((b, t)) < 0.5,
            "noise": rng.gumbel(size=(b, t, 2, v)).astype(np.float32),
            "idx": negative_indices_from_uniform(
                torch.from_numpy(u), torch.from_numpy(frames)).numpy()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny JAX pretrain ``fit`` over 3 epochs of 2 batches, preempted in
    its second epoch, and a JAX resume of a copy of its directory; every
    step and validation takes the same fixed draws (span mask, Gumbel
    noise, distractors), which the port's resume takes too."""
    root = tmp_path_factory.mktemp("jax_pretrain")
    cfg_t = tcfg.tiny_config(**TINY)
    v, k, n = 8, 5, 8000
    t = int(cfg_t.feat_extract_output_lengths(n))
    draws = _fixed_draws(2, t, v, k)
    rng = np.random.default_rng(18)
    batches = []
    for _ in range(2):
        audio = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
        audio[1, n - 7 * 320:] = 0.0
        batches.append({"audio": audio,
                        "audio_lengths": np.array([n, n - 7 * 320], np.int32),
                        "gumbel_temp": np.full(2, 1.5, np.float32)})
    valid = [batches[0]]
    head = dict(num_negatives=k)
    params = random_jax_params(cfg_t, 41, **head)
    jm = jax_model(**head)
    common = dict(num_epochs=3, batch_size=2, learning_rate=1e-3, seed=0,
                  lr_decay=0.5, mask_prob=0.5, num_negatives=k,
                  codevector_vars=v, codevector_dim=16,
                  proj_codevector_dim=16)
    engine = eval_fwd = None

    def jax_validate(p, epoch):
        sums = {key: 0.0 for key in tpretrain.VAL_KEYS}
        for batch in valid:
            out = eval_fwd(p, jnp.asarray(batch["audio"]),
                           jnp.asarray(batch["audio_lengths"]))
            for key in sums:
                sums[key] += float(out[key])
        return {f"val_{key}": s / len(valid) for key, s in sums.items()}

    def jax_fit(exp_dir, at, resume):
        nonlocal engine, eval_fwd
        cfg = jpretrain.PretrainConfig(exp_dir=str(exp_dir), mesh_data=1,
                                       **common)
        cfg.train_from_ckpt = resume
        engine = engine or jharness.make_engine(
            cfg, jpretrain.pretrain_loss_fn(jm, cfg))
        eval_fwd = eval_fwd or jpretrain.make_eval_forward(jm)
        return jloop.fit(cfg, None, params, _PreemptingLoader(batches, at),
                         jax_validate,
                         jckpt.CheckpointManager(exp_dir, "val_loss"),
                         log_fn=lambda m: None, engine=engine)[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, dtype: jnp.asarray(draws["noise"]))
        mp.setattr(jpre_model, "sample_negative_indices",
                   lambda *a: jnp.asarray(draws["idx"]))
        mp.setattr(jpretrain, "_compute_time_mask",
                   lambda *a: jnp.asarray(draws["mask"]))
        mp.setattr(tpre_model, "gumbel_noise",
                   lambda *a: torch.from_numpy(draws["noise"]))
        mp.setattr(tpre_model, "sample_negative_indices",
                   lambda *a: torch.from_numpy(draws["idx"]))
        mp.setattr(tpretrain, "compute_time_mask",
                   lambda *a: torch.from_numpy(draws["mask"]))
        resumed = {}

        def port_fit(exp_dir):
            resumed["dir"] = exp_dir
            # other weights: only the restore can make the runs agree
            model = port_from_jax(cfg_t, random_jax_params(cfg_t, 42, **head),
                                  **head)
            cfg = tpretrain.PretrainConfig(
                exp_dir=str(exp_dir), platform="cpu", train_from_ckpt=True,
                **common)
            step = make_engine(cfg, tpretrain.pretrain_loss_fn(
                cfg.mask_prob), model)
            port_eval = tpretrain.make_eval_forward(model)
            log_fn, seen = _port_restore_probe(step)

            def validate(epoch):
                outs = [port_eval(b["audio"], b["audio_lengths"])
                        for b in valid]
                return {f"val_{key}": float(np.mean([o[key].item()
                                                     for o in outs]))
                        for key in tpretrain.VAL_KEYS}

            _, hist = fit(cfg, None, model, _PreemptingLoader(batches),
                          validate, CheckpointManager(exp_dir, "val_loss"),
                          log_fn=log_fn, engine=step)
            return hist, dict(seen, n_trainable=len(
                step.optimizer.param_groups[0]["params"]))

        j_hist, t_hist, meta, seen = _resume_jax_run(root, jax_fit, port_fit)
        port_eval = tpretrain.make_eval_forward(port_from_jax(cfg_t, params,
                                                              **head))
        audio, lengths = valid[0]["audio"], valid[0]["audio_lengths"]
        eval_outs = ({key: np.asarray(o) for key, o in eval_fwd(
            params, audio, lengths).items()},
            {key: o.numpy() for key, o in port_eval(audio, lengths).items()})
    return dict(root=root, cfg_t=cfg_t, head=head, j_hist=j_hist,
                t_hist=t_hist, meta=meta, seen=seen, eval_outs=eval_outs)


def test_port_resumes_a_jax_pretrain_run(jax_run):
    meta, seen = jax_run["meta"], jax_run["seen"]
    # epoch 0's two steps and the step the preemption let finish
    assert meta["step"] == 3
    assert seen["step"] == 3 and seen["adam_steps"] == [3.0]
    # every parameter trains: the feature extractor and the quantizer too
    assert seen["n_state"] == seen["n_trainable"] == len(
        list(Wav2Vec2Pretrain(jax_run["cfg_t"], **{
            **HEAD, **jax_run["head"]}).parameters()))
    j_hist, t_hist = jax_run["j_hist"], jax_run["t_hist"]
    _assert_resumes_match(j_hist, t_hist, "val_loss")
    for t, j in zip(t_hist, j_hist):
        for k in tpretrain.VAL_KEYS:
            _rel_close(t[f"val_{k}"], j[f"val_{k}"], k, rel=1e-4)


def test_equal_draws_give_equal_validation(jax_run):
    """The validation forward on the same weights and the same draws: the
    port's fixed generators are the only difference from JAX's keys."""
    want, got = jax_run["eval_outs"]
    assert set(got) == set(want) == set(OUTPUTS)
    for k in ("num_masked", "frame_lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in OUTPUTS[:6]:
        _rel_close(float(got[k]), float(want[k]), k)


@pytest.mark.parametrize("build", ["build_pr_model", "build_aptai_model"])
def test_jax_pretrain_run_grafts(jax_run, build):
    root = jax_run["root"]
    want = any_state_dict_from_jax(load_flax_params(
        root / "jax" / "best-model-ckpt" / "params.msgpack"))
    cfg = tconfig.APTAIConfig(platform="cpu",
                              pretrained_checkpoint=str(root / "jax"))
    model, _ = getattr(builders, build)(cfg, {f"p{i}": i for i in range(5)},
                                        tiny=jax_run["cfg_t"], seed=2)
    got = model.wav2vec2.state_dict()
    assert "masked_spec_embed" in got
    assert all(torch.equal(v, want[f"wav2vec2.{k}"]) for k, v in got.items())
