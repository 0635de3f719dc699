"""aptai_tpu_torch's HPRC preparation (``data/hprc_prep.py``) against the
JAX package's, over one raw ``.mat`` tree (two speakers, F02's layout
among them, N and F rates, R01 and R02, audio at 22.05 kHz so the
resample runs), prepared once by each package's ``prepare_hprc`` in a
module fixture. Every utterance lasts 1 s, so the JAX signal ops compile
once.

Everything the host computes is held bit for bit: the manifests (root
swapped), the vocabulary, the wavs, the texts, and the EMA, ``ema_low``,
palate, TV, ``tvs_norm``, 49 Hz and F0 pickles by value and dtype. The
log-mel and MFCC pickles are computed by the two packages' signal ops and
held to ``tests/test_torch_signal.py``'s tolerance: 1e-4 relative to the
JAX value's largest magnitude (FFT and matmul summation orders differ
behind a log).
"""

import pickle
import shutil

import numpy as np
import pandas as pd
import pytest

from aptai_tpu.data import hprc as jhprc
from aptai_tpu.data import hprc_prep as jprep
from aptai_tpu_torch.data import hprc as thprc
from aptai_tpu_torch.data import hprc_prep as tprep
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.data.synthetic import make_synthetic_hprc_raw
from aptai_tpu_torch.data.vocab import load_vocab

from _torch_port import one_torch_thread

SPECTRAL_RTOL = 1e-4
HOST_DIRS = ("ema", "ema_low", "tvs", "tvs_norm", "tvs_49hz",
             "tvs_norm_49hz", "f0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("hprc")
    raw = root / "raw"
    keys = make_synthetic_hprc_raw(raw, speakers=("M01", "F02"), texts=1,
                                   seconds=(1.0, 1.0), fs=22_050, seed=3,
                                   phonemes_root=root / "port")
    shutil.copytree(root / "port", root / "jax")
    logs = []
    port_csv = tprep.prepare_hprc(raw, root / "port", log=logs.append,
                                  device="cpu")
    jax_csv = jprep.prepare_hprc(raw, root / "jax", log=lambda *_: None)
    return {"root": root, "keys": keys, "port": root / "port",
            "jax": root / "jax", "port_csv": port_csv, "jax_csv": jax_csv,
            "logs": logs}


def _swapped(path, root):
    return path.read_bytes().replace(str(root).encode(), b"<ROOT>")


def _files(tree, sub):
    return sorted(p.relative_to(tree) for p in tree.glob(f"*/{sub}/*"))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(got, want, path=""):
    """Deep equality: dicts, lists, arrays (dtype too), scalars (type
    too, NaN equal to NaN), None."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and np.isnan(want):  # EMA dropouts
        assert np.isnan(got) and type(got) is type(want), (path, got)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def test_manifest_and_vocab_equal_the_jax_ones(trees):
    """``hprc.csv`` after ``add_phn_frames_to_csv`` (pandas' rewrite on the
    JAX side) byte for byte with each tree's root swapped, R01 only, and
    ``vocab.json``; then ``build_hprc_csv`` alone (the csv module's
    CRLF file before the rewrite)."""
    got = _swapped(trees["port_csv"], trees["port"])
    assert got == _swapped(trees["jax_csv"], trees["jax"])
    rows = read_rows(trees["port_csv"])
    assert len(rows) == 4 and all("R01" in r["path_wav"] for r in rows)
    assert {r["speaker"] for r in rows} == {"M01", "F02"}
    assert ((trees["port"] / "vocab.json").read_bytes()
            == (trees["jax"] / "vocab.json").read_bytes())
    port_raw = tprep.build_hprc_csv(trees["port"])
    jax_raw = jprep.build_hprc_csv(trees["jax"])
    assert b"\r\n" in port_raw.read_bytes()
    assert _swapped(port_raw, trees["port"]) == _swapped(jax_raw, trees["jax"])
    vocab = load_vocab(trees["port"] / "vocab.json")
    tprep.add_phn_frames_to_csv(port_raw, vocab)
    jprep.add_phn_frames_to_csv(jax_raw, vocab)
    assert _swapped(port_raw, trees["port"]) == got


def test_wavs_and_texts_equal_the_jax_ones(trees):
    """The 16 kHz float32 wavs (resampled from 22.05 kHz by ``resample_np``)
    and the lower-cased word transcripts, byte for byte."""
    for sub, n in (("audio", 8), ("text", 8)):
        files = _files(trees["port"], sub)
        assert len(files) == n and files == _files(trees["jax"], sub)
        for rel in files:
            assert ((trees["port"] / rel).read_bytes()
                    == (trees["jax"] / rel).read_bytes()), rel
    text = (trees["port"] / "M01" / "text"
            / "M01_B01_S01_R01_N.txt").read_text()
    assert text == text.lower() and " sp " not in f" {text} "


@pytest.mark.parametrize("sub", HOST_DIRS)
def test_host_pickles_equal_bit_for_bit(trees, sub):
    """Every pickle of ``sub`` (the palate's in ``ema`` and ``ema_low``
    too) equals the JAX one by value, dtype and type; F02 has no ML
    sensor."""
    files = _files(trees["port"], sub)
    want_n = {"ema": 10, "ema_low": 10}.get(sub, 8)
    assert len(files) == want_n and files == _files(trees["jax"], sub)
    for rel in files:
        _same(_load(trees["port"] / rel), _load(trees["jax"] / rel), str(rel))
    if sub == "ema":
        f02 = _load(trees["port"] / "F02" / "ema" / "F02_B01_S01_R01_N.pkl")
        assert "ML" not in f02 and "JAWL" in f02
        m01 = _load(trees["port"] / "M01" / "ema" / "M01_B01_S01_R01_N.pkl")
        assert "ML" in m01 and np.isnan(m01["TT"]["x"]).any()


@pytest.mark.parametrize("sub", ["mspec", "mfccs"])
def test_spectrograms_within_the_signal_tolerance(trees, sub):
    """Log-mel (frames, 80) and MFCC (13, frames) float32, within
    ``SPECTRAL_RTOL`` of the JAX values; fetched as numpy, not tensors."""
    files = _files(trees["port"], sub)
    assert len(files) == 8 and files == _files(trees["jax"], sub)
    for rel in files:
        got, want = _load(trees["port"] / rel), _load(trees["jax"] / rel)
        assert type(got) is np.ndarray and got.dtype == want.dtype
        assert got.shape == want.shape == ((63, 80) if sub == "mspec"
                                           else (13, 50))
        rel_err = np.abs(got - want).max() / np.abs(want).max()
        assert rel_err <= SPECTRAL_RTOL, (rel, rel_err)


def test_each_package_serves_the_other_tree(trees):
    """The JAX ``HPRCDataset`` over the port's tree gives the port's
    dataset's items bit for bit, and the port's over the JAX tree the JAX
    one's; across the trees the items differ only in their paths and
    within ``SPECTRAL_RTOL`` in the spectrograms."""
    vocab = load_vocab(trees["port"] / "vocab.json")
    items = {}
    for tree in ("port", "jax"):
        csv_path = trees[f"{tree}_csv"]
        for rate in ("both", "N"):
            got = thprc.HPRCDataset(read_rows(csv_path), vocab, rate)
            want = jhprc.HPRCDataset(pd.read_csv(csv_path), vocab, rate)
            assert len(got) == len(want) == (4 if rate == "both" else 2)
            got = [got[i] for i in range(len(got))]
            _same(got, [want[i] for i in range(len(want))])
            items[tree, rate] = got
    for a, b in zip(items["port", "both"], items["jax", "both"]):
        for key in ("mspec", "mfccs"):
            assert np.abs(a.pop(key) - b[key]).max() <= (
                SPECTRAL_RTOL * np.abs(b.pop(key)).max())
        assert a.pop("utt_key").replace(str(trees["port"]), "") == \
            b.pop("utt_key").replace(str(trees["jax"]), "")
        _same(a, b)


def test_second_pass_writes_nothing_and_a_cut_run_resumes(trees):
    """A second ``prepare_hprc`` over the prepared tree writes no pickle
    and the same manifest; with an ``mspec``, a ``tvs_norm`` and an
    ``ema_low`` pickle deleted, a third writes those three again, as the
    JAX package's ``prepare_hprc`` does, to the same values."""
    port = trees["port"]
    before = {p: p.stat().st_mtime_ns for p in port.rglob("*.pkl")}
    manifest = trees["port_csv"].read_bytes()
    logs = []
    tprep.prepare_hprc(None, port, log=logs.append, device="cpu")
    counts = [line.split()[0] for line in logs if line.startswith("      ")
              and not line.strip().startswith("/")]
    assert counts == ["0"] * 5, logs
    assert {p: p.stat().st_mtime_ns for p in port.rglob("*.pkl")} == before
    assert trees["port_csv"].read_bytes() == manifest
    assert trees["logs"][0].startswith("[1/8] extract_mat")
    assert [line[:5] for line in logs if line.startswith("[")] == [
        f"[{i}/8]" for i in range(1, 9)]

    cut = ["M01/mspec/M01_B01_S01_R02_F.pkl",
           "F02/tvs_norm/F02_B01_S01_R01_N.pkl",
           "F02/ema_low/F02_palate.pkl"]
    kept = {rel: _load(port / rel) for rel in cut}
    for rel in cut:
        (port / rel).unlink()
    assert tprep.write_acoustic_features(port, device="cpu") == 1
    assert tprep.write_lowpass_ema(port) == 1
    assert tprep.write_tv_norm(port) == 1
    assert jprep.write_acoustic_features(trees["jax"]) == 0
    for rel, value in kept.items():
        _same(_load(port / rel), value, rel)
