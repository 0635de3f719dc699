"""aptai_tpu_torch's batch inference CLI (``python -m aptai_tpu_torch.infer``)
against the JAX package's (``python -m aptai_tpu.infer``), on the CPU, on
checkpoints the JAX ``CheckpointManager`` wrote:

* for each model kind, the JSON lines on stdout and the ``--out`` files
  hold the same keys, the same integers and phoneme strings, and numbers
  within 1e-4 of the largest magnitude of their list (an utterance's TVs:
  of its (T, 9) matrix, as the port's FORCE tests hold ``tvs_pred``);
* ``--task alignment`` on FORCE-APTAI, and exit code 2 on any other kind;
* the port's own checkpoint of the same weights gives the same output.

The JAX CLI gets its model and tree handed over (its loader's eager
``init`` compiles for seconds in a fresh process) and runs without its
native library (the Python beam), so nothing builds inside the JAX tree.
"""

import dataclasses
import json

import numpy as np
import pytest

from aptai_tpu.decode import native as jnative
from aptai_tpu.infer import __main__ as jcli
from aptai_tpu.infer import loader as jloader
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.data.audio_io import save_wav
from aptai_tpu_torch.infer.__main__ import main as cli_main
from aptai_tpu_torch.models import (force_aptai_state_dict_from_jax,
                                    state_dict_from_jax,
                                    w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.train import checkpoints as tckpt

from _torch_port import (jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
VOCAB = {f"p{i}": i for i in range(V)}
BRIDGES = {"w2v2_pr": w2v2_pr_state_dict_from_jax,
           "aptai": state_dict_from_jax,
           "force_aptai": force_aptai_state_dict_from_jax}
KINDS = ("aptai", "force_aptai", "w2v2_pr")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


@pytest.fixture(autouse=True)
def _jax_without_native(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)


def _jax_model(kind):
    cfg = jcfg.tiny_config(**STACK)
    if kind == "aptai":
        return JaxAPTAI(cfg, num_phonemes=V)
    if kind == "w2v2_pr":
        return JaxW2V2PR(cfg)
    return JaxForceAPTAI(cfg, vocab_size=V, decode_method="greedy")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three wavs (one at 8 kHz, resampled on load), and per kind a JAX
    checkpoint, a port checkpoint of the same weights and the JAX tree."""
    root = tmp_path_factory.mktemp("infercli")
    rng = np.random.default_rng(50)
    wavs = []
    for i, (n, sr) in enumerate(((20_800, 16_000), (33_000, 16_000),
                                 (9_000, 8_000))):
        path = root / f"utt{i}.wav"
        save_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32), sr)
        wavs.append(str(path))
    cfg_t = tcfg.tiny_config(**STACK)
    trees = {"aptai": random_jax_aptai_params(cfg_t, V, 51),
             "w2v2_pr": random_jax_w2v2_pr_params(cfg_t, 52),
             "force_aptai": random_jax_force_params(
                 jcfg.tiny_config(**STACK), V, 53)}
    out = {"wavs": wavs, "trees": trees}
    for kind, params in trees.items():
        model_cfg = {"backbone": dataclasses.asdict(jcfg.tiny_config(
            **STACK)), "vocab": VOCAB, "kind": kind}
        if kind == "force_aptai":
            model_cfg["decode_method"] = "greedy"
        jckpt.CheckpointManager(root / f"{kind}_jax", "m").update(
            0, {"m": 1.0}, params, model_cfg=model_cfg)
        tckpt.CheckpointManager(root / f"{kind}_port", "m").update(
            0, {"m": 1.0}, BRIDGES[kind](params), model_cfg=model_cfg)
        out[kind] = (str(root / f"{kind}_jax"), str(root / f"{kind}_port"))
    return out


def _lines(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return [json.loads(line) for line in out.splitlines()]


def _jax_lines(capsys, monkeypatch, setup, kind, argv):
    """The JAX CLI's output over ``setup``'s tree of ``kind``."""
    monkeypatch.setattr(jloader, "load_model", lambda path, dtype=None: (
        kind, _jax_model(kind), setup["trees"][kind], VOCAB))
    return _lines(capsys, jcli.main, argv)


def _same(got, want, path=""):
    """Same keys and strings, equal integers, numbers within 1e-4 of the
    largest magnitude of their list; a ``tvs_pred`` dict is compared as
    the (T, 9) matrix the predictor made it from."""
    if path.endswith("tvs_pred"):
        assert set(got) == set(want) == set(TV_ORDER), path
        got, want = ([d[k] for k in TV_ORDER] for d in (got, want))
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list) and want and isinstance(
            np.asarray(want).flat[0], (float, np.floating)):
        w = np.asarray(want, np.float64)
        g = np.asarray(got, np.float64)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=path)
    elif isinstance(want, list) and want and isinstance(want[0],
                                                        (dict, list)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("kind", KINDS)
def test_json_lines_match_the_jax_cli(setup, capsys, monkeypatch, kind):
    jax_ckpt, port_ckpt = setup[kind]
    args = setup["wavs"] + ["--batch_size", "2"]
    got = _lines(capsys, cli_main, [jax_ckpt, *args, "--cpu"])
    want = _jax_lines(capsys, monkeypatch, setup, kind, [jax_ckpt, *args])
    assert [g["utterance"] for g in got] == ["utt0", "utt1", "utt2"]
    _same(got, want)
    # the port's checkpoint of the same weights
    _same(_lines(capsys, cli_main, [port_ckpt, *args, "--cpu"]), got)


@pytest.mark.parametrize("kind", ["force_aptai", "w2v2_pr"])
def test_out_files_match_the_jax_cli(setup, capsys, monkeypatch, tmp_path,
                                     kind):
    jax_ckpt, _ = setup[kind]
    wavs = setup["wavs"][:2]
    cli_main([jax_ckpt, *wavs, "--cpu", "--out", str(tmp_path / "port"),
              "--transfer_dtype", "int16"])
    _jax_lines(capsys, monkeypatch, setup, kind,
               [jax_ckpt, *wavs, "--out", str(tmp_path / "jax"),
                "--transfer_dtype", "int16"])
    for stem in ("utt0", "utt1"):
        _same(json.loads((tmp_path / "port" / f"{stem}.json").read_text()),
              json.loads((tmp_path / "jax" / f"{stem}.json").read_text()))


def test_alignment_task(setup, capsys, monkeypatch):
    jax_ckpt, _ = setup["force_aptai"]
    wavs = setup["wavs"][:2]
    got = _lines(capsys, cli_main, [jax_ckpt, *wavs, "--task", "alignment",
                                    "--cpu"])
    want = _jax_lines(capsys, monkeypatch, setup, "force_aptai",
                      [jax_ckpt, *wavs, "--task", "alignment"])
    assert np.asarray(got[0]["alignment"]).ndim == 2
    _same(got, want)


@pytest.mark.parametrize("kind", ["aptai", "w2v2_pr"])
def test_alignment_needs_a_force_checkpoint(setup, capsys, kind):
    rc = cli_main([setup[kind][1], setup["wavs"][0], "--task", "alignment",
                   "--cpu"])
    assert rc == 2
    assert "needs a force_aptai checkpoint" in capsys.readouterr().err
