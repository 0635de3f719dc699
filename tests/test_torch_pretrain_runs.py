"""aptai_tpu_torch's wav2vec2 pretraining trainer against the JAX package's,
float32 on the CPU, tiny config (2 layers, the 7-layer conv stack at 16
channels):

* ``PretrainAudioDataset``'s crops and ``collate_audio`` against JAX's;
* ``pretrain.run`` for 2 epochs on a synthetic CommonPhone corpus, then
  its best checkpoint grafted into ``build_pr_model`` and
  ``build_aptai_model`` bit for bit; ``main`` on the card unless asked;
* a JAX pretrain run preempted mid-epoch (made once per module): grafted
  by the port's builders, and resumed by the port's ``fit`` (params, Adam
  moments by name, step, watermark), the remaining epochs' losses and
  ``val_*`` metrics within 1e-4 of the JAX resume's. Flax's random streams
  cannot be reproduced in torch, so both sides take the same injected
  draws (the span mask, the Gumbel noise, the distractors), which also
  pins the validation forward's fixed generators (ROADMAP Queue 3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_trainers import (_PreemptingLoader, _assert_resumes_match,
                                 _port_restore_probe, _resume_jax_run)

from aptai_tpu.models import pretrain as jpre_model
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train import harness as jharness
from aptai_tpu.train import loop as jloop
from aptai_tpu.train import pretrain as jpretrain
from aptai_tpu_torch.data import make_synthetic_commonphone
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import pretrain as tpre_model
from aptai_tpu_torch.models.convert import any_state_dict_from_jax
from aptai_tpu_torch.models.pretrain import (Wav2Vec2Pretrain,
                                             negative_indices_from_uniform,
                                             random_wav2vec2_pretrain,
                                             sample_negative_indices)
from aptai_tpu_torch.train import builders
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train import pretrain as tpretrain
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               load_flax_params, read_params)
from aptai_tpu_torch.train.harness import make_engine
from aptai_tpu_torch.train.loop import fit

from _torch_port import one_torch_thread
from _torch_pretrain_tiny import (HEAD, OUTPUTS, STACK, TINY, _rel_close,
                                  jax_model, port_from_jax, random_jax_params)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


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
              "best-model-ckpt/params.msgpack",
              "last-model-ckpt/opt_state.msgpack"):
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
    best = read_params(exp / "best-model-ckpt")
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
                step.optimizer.param_groups[0]["params"]),
                final=model.state_dict())

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
