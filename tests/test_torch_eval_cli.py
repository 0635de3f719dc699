"""aptai_tpu_torch's ``eval_cli`` on the CPU:

* on a checkpoint this package wrote and on one the JAX package wrote, for
  each model kind: one JSON object on stdout with the metrics of the kind,
  the same for both formats of the same weights (1e-4 relative);
* against the JAX ``eval_cli`` on the same checkpoint and manifest: the
  same keys and values within 1e-4 relative;
* exit code 2 on the filters and rates the JAX CLI refuses
  (``tests/test_eval_cli.py``), and ``--csv``.
"""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest

from aptai_tpu.infer import loader as jloader
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train.eval_cli import main as jax_eval_main
from aptai_tpu_torch.data import (build_vocab, make_synthetic_commonphone,
                                  make_synthetic_hprc)
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import (force_aptai_state_dict_from_jax,
                                    state_dict_from_jax,
                                    w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.train import checkpoints as tckpt
from aptai_tpu_torch.train.eval_cli import main as eval_main

from _torch_port import (jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)

# the 7-layer conv stack (49 frames a second, as the manifests), tiny widths
STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
BRIDGES = {"w2v2_pr": w2v2_pr_state_dict_from_jax,
           "aptai": state_dict_from_jax,
           "force_aptai": force_aptai_state_dict_from_jax}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


def _write(root, name, kind, params, vocab, jax_format):
    """One best checkpoint of ``params`` (a JAX tree), in the JAX
    package's format or, through the bridge, in this package's."""
    backbone = jcfg.tiny_config(**STACK)
    if kind == "w2v2_pr":
        backbone = dataclasses.replace(backbone, vocab_size=len(vocab))
    model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": vocab,
                 "kind": kind}
    if kind == "force_aptai":
        model_cfg["decode_method"] = "greedy"
    exp = root / name
    if jax_format:
        jckpt.CheckpointManager(exp, "m").update(0, {"m": 1.0}, params,
                                                 model_cfg=model_cfg)
    else:
        tckpt.CheckpointManager(exp, "m").update(
            0, {"m": 1.0}, BRIDGES[kind](params), model_cfg=model_cfg)
    return exp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalcli")
    cp_csv = make_synthetic_commonphone(root / "cp", 4, 2, 2)
    hprc_csv = make_synthetic_hprc(root / "hprc", 1, ("M01", "F02"),
                                   device="cpu")
    cp_vocab = build_vocab(r["phonemes"] for r in read_rows(cp_csv))
    hprc_vocab = build_vocab(r["phoneme_labels"] for r in read_rows(hprc_csv))
    cfg_t = tcfg.tiny_config(**STACK)
    trees = {
        "pr": ("w2v2_pr", random_jax_w2v2_pr_params(
            dataclasses.replace(cfg_t, vocab_size=len(cp_vocab)), 1),
            cp_vocab),
        "pr_hprc": ("w2v2_pr", random_jax_w2v2_pr_params(
            dataclasses.replace(cfg_t, vocab_size=len(hprc_vocab)), 2),
            hprc_vocab),
        "aptai": ("aptai", random_jax_aptai_params(cfg_t, len(hprc_vocab),
                                                   3), hprc_vocab),
        "force": ("force_aptai", random_jax_force_params(
            jcfg.tiny_config(**STACK), len(hprc_vocab), 4), hprc_vocab)}
    out = {"cp_csv": cp_csv, "hprc_csv": hprc_csv, "trees": trees}
    for name, (kind, params, vocab) in trees.items():
        for jax_format in (False, True):
            out[name, jax_format] = _write(
                root, f"{name}_{'jax' if jax_format else 'port'}", kind,
                params, vocab, jax_format)
    return out


def _run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return json.loads(out)


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, got[k],
                                                                  v)
        elif k != "checkpoint":
            assert got[k] == v, k


CASES = {  # checkpoint, manifest, arguments, keys the result must have
    "pr_cp_split": ("pr", "cp_csv", ["--split", "test", "--decode",
                                     "greedy"], ["mean_cp_per",
                                                 "mean_cp_loss"]),
    "pr_hprc_rates": ("pr_hprc", "hprc_csv", ["--decode", "beam"],
                      ["mean_hprcN_per", "mean_hprcF_per"]),
    "aptai": ("aptai", "hprc_csv", ["--rate", "N"],
              ["test_N_mean_rmse", "test_N_mean_pcc", "test_N_mean_FER",
               "test_N_mean_PER", "test_N_mean_overlap"]),
    "force": ("force", "hprc_csv", ["--rate", "N,F"],
              ["test_N_mean_rmse", "test_N_ctc_seq_per",
               "test_F_ctc_seq_per"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_and_jax_checkpoints_score_alike(setup, capsys, case):
    name, manifest, args, keys = CASES[case]
    results = [_run(capsys, eval_main, [str(setup[name, jax_format]),
                                        str(setup[manifest]), "--cpu"]
                    + args) for jax_format in (False, True)]
    for res in results:
        for k in keys:
            assert k in res and np.isfinite(res[k]), k
        assert res["utterances"] > 0
    _same(results[0], results[1])


def test_matches_the_jax_cli(setup, capsys, tmp_path, monkeypatch):
    ckpt = str(setup["aptai", True])
    argv = [ckpt, str(setup["hprc_csv"]), "--rate", "N,F", "--speaker",
            "F02"]
    got = _run(capsys, eval_main, argv + ["--cpu", "--csv",
                                          str(tmp_path / "m.csv")])
    # the JAX CLI over the same tree, handed over without its loader's
    # eager init (seconds of op-by-op compiles on a fresh process)
    _, params, vocab = setup["trees"]["aptai"]
    monkeypatch.setattr(jloader, "load_model", lambda path, dtype=None: (
        "aptai", JaxAPTAI(jcfg.tiny_config(**STACK),
                          num_phonemes=len(vocab)), params, vocab))
    want = _run(capsys, jax_eval_main, argv)
    _same(got, want)
    assert got["utterances"] == 2
    row = pd.read_csv(tmp_path / "m.csv").iloc[0]
    assert row["test_N_mean_rmse"] == pytest.approx(got["test_N_mean_rmse"])


def test_usage_errors_exit_2(setup, capsys, tmp_path):
    aptai, hprc_csv = str(setup["aptai", False]), str(setup["hprc_csv"])

    def rc(*argv):
        return eval_main(list(argv) + ["--cpu"])

    # a TV model on a CommonPhone manifest, a split value no row has, a
    # split column the manifest lacks, bad rates
    assert rc(aptai, str(setup["cp_csv"])) == 2
    assert rc(str(setup["pr", False]), str(setup["cp_csv"]), "--split",
              "nope") == 2
    assert rc(aptai, hprc_csv, "--split", "test") == 2
    assert rc(aptai, hprc_csv, "--rate", "n") == 2
    assert rc(aptai, hprc_csv, "--rate", ",") == 2
    assert rc(aptai, hprc_csv, "--speaker", "NOBODY") == 2
    # every row misses the requested rate: no metrics, not a JSON of none
    df = pd.read_csv(hprc_csv)
    n_only = tmp_path / "n_only.csv"
    df[df.rate == "N"].to_csv(n_only, index=False)
    capsys.readouterr()
    assert rc(aptai, str(n_only), "--rate", "F") == 2
    assert "no metrics" in capsys.readouterr().err
