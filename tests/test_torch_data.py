"""aptai_tpu_torch's data layer against the JAX package's, on the CPU:

* the synthetic generators: the same audio, TV pickles, labels and
  manifest text from the same seed; mspec and MFCC within the signal
  tolerance (1e-4 of the largest magnitude, float32);
* ``HPRCDataset`` and ``CommonPhoneDataset`` (cropping on and off) read a
  JAX-written corpus to the same items, and each package reads the other's
  manifest (pandas on the JAX side, the port's ``manifest`` module on its
  own); an empty ``path_f0`` cell is absent in both;
* ``collate_ctc`` / ``collate_tv``, ``BucketedLoader`` over two epochs and
  a process shard, ``PrefetchLoader`` (and its error);
* ``loso_split`` and ``trim_csv`` against the JAX / pandas ones, and
  ``commonphone_csv`` / ``remap_speakers`` on a small corpus tree.

Integers, text and audio must be equal. The corpora are written once per
module; the JAX generator's spectrogram ops run jitted (one program per
utterance length, the same functions)."""

import pickle
import shutil

import jax
import numpy as np
import pandas as pd
import pytest

from aptai_tpu import data as jdata
from aptai_tpu.data import commonphone as jcp
from aptai_tpu.data import hprc as jhprc
from aptai_tpu.ops import signal as jsignal
from aptai_tpu_torch import data as tdata
from aptai_tpu_torch.data import commonphone as tcp
from aptai_tpu_torch.data import hprc as thprc
from aptai_tpu_torch.data.manifest import read_rows, write_rows

from _torch_port import one_torch_thread

SPEAKERS = ("M01", "F02", "M03")
SIGNAL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The HPRC and CommonPhone corpora of both generators from seed 0 (3
    speakers × 1 text × 2 rates; 8 + 2 + 2 CommonPhone utterances)."""
    root = tmp_path_factory.mktemp("corpora")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsignal, "melspectrogram", jax.jit(jsignal.melspectrogram))
        mp.setattr(jsignal, "mfcc", jax.jit(jsignal.mfcc))
        jax_hprc = jdata.make_synthetic_hprc(root / "jh", 1, SPEAKERS)
    return {
        "jax_hprc": jax_hprc,
        "port_hprc": tdata.make_synthetic_hprc(root / "th", 1, SPEAKERS,
                                               device="cpu"),
        "jax_cp": jdata.make_synthetic_commonphone(root / "jc"),
        "port_cp": tdata.make_synthetic_commonphone(root / "tc"),
    }


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _same(got, want, path=""):
    """Deep equality of items: dicts, lists, arrays, scalars, None."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_synthetic_generators_match_jax(corpora):
    """Manifest text equal but for the roots; per utterance the wav, the
    four TV pickles and the frame labels equal, mspec and MFCC within the
    signal tolerance."""
    for key, jkey in (("port_hprc", "jax_hprc"), ("port_cp", "jax_cp")):
        got, want = corpora[key], corpora[jkey]
        assert (got.read_text().replace(str(got.parent), "R")
                == want.read_text().replace(str(want.parent), "R"))
    rows_t = read_rows(corpora["port_hprc"])
    rows_j = read_rows(corpora["jax_hprc"])
    assert len(rows_t) == 2 * len(SPEAKERS)
    for rt, rj in zip(rows_t, rows_j):
        np.testing.assert_array_equal(tdata.load_wav_16k(rt["path_wav"]),
                                      jdata.load_wav_16k(rj["path_wav"]))
        for col in ("path_tvs", "path_tvs_49hz", "path_tvs_norm",
                    "path_tvs_norm_49hz"):
            _same(_load(rt[col]), _load(rj[col]), col)
        for col in ("path_mspec", "path_mfccs"):
            got, want = _load(rt[col]), _load(rj[col])
            assert got.dtype == want.dtype == np.float32
            assert _rel(got, want) <= SIGNAL_TOL, col


def _hprc_items(ds):
    return [ds[i] for i in range(len(ds))]


def test_hprc_dataset_reads_both_manifests(corpora, tmp_path):
    """Both packages read the JAX-written manifest, and the port-written
    one, to the same items; an ``f0`` column with an empty cell gives
    ``None`` there and the pickle elsewhere, in both."""
    df = pd.read_csv(corpora["jax_hprc"])
    vocab = jdata.build_vocab(df.phoneme_labels)
    f0_csv = tmp_path / "with_f0.csv"
    f0 = tmp_path / "f0.pkl"
    with open(f0, "wb") as f:
        pickle.dump(np.arange(5.0), f)
    df["path_f0"] = [str(f0)] + [None] * (len(df) - 1)
    df.to_csv(f0_csv, index=False)
    for csv_path in (corpora["jax_hprc"], corpora["port_hprc"], f0_csv):
        for rate in ("both", "F"):
            got = _hprc_items(thprc.HPRCDataset(read_rows(csv_path), vocab,
                                                rate))
            want = _hprc_items(jhprc.HPRCDataset(pd.read_csv(csv_path),
                                                 vocab, rate))
            assert len(got) == (len(df) if rate == "both" else len(df) // 2)
            _same(got, want)
    full = thprc.HPRCDataset(read_rows(f0_csv), vocab, "both")
    np.testing.assert_array_equal(full[0]["f0"], np.arange(5.0))
    assert full[1]["f0"] is None
    with pytest.raises(ValueError, match="rate"):
        thprc.HPRCDataset([], vocab, "X")


def test_commonphone_dataset_and_collate_ctc(corpora):
    """Uncropped over every row, and cropped (from the seeded stream) over
    the utterances longer than a second, read from the JAX-written
    manifest by both; then ``collate_ctc`` over the items."""
    csv_path = corpora["jax_cp"]
    df = pd.read_csv(csv_path)
    vocab = jdata.build_vocab(df.phonemes)
    rows = read_rows(csv_path)
    got = [tcp.CommonPhoneDataset(rows, vocab)[i] for i in range(len(rows))]
    want = [jcp.CommonPhoneDataset(df, vocab)[i] for i in range(len(df))]
    _same(got, want)
    long = [i for i, r in enumerate(rows) if tcp.parse_timestamp_tuples(
        r["phoneme_timestamps"])[-1][1] > 1.05]
    assert len(long) >= 3
    ds_t = tcp.CommonPhoneDataset([rows[i] for i in long], vocab,
                                  cropping=True, seed=4)
    ds_j = jcp.CommonPhoneDataset(df.iloc[long], vocab, cropping=True,
                                  seed=4)
    crops = [ds_t[i % len(long)] for i in range(2 * len(long))]
    _same(crops, [ds_j[i % len(long)] for i in range(2 * len(long))])
    assert all(c["audio_len"] == 16_000 for c in crops)
    for bucket in (True, False):
        _same(tdata.collate_ctc(got[:5], bucket),
              jdata.collate_ctc(want[:5], bucket))


def _loaders(ds_t, ds_j, collate_t, collate_j, **kw):
    return (tdata.BucketedLoader(ds_t, collate_fn=collate_t, **kw),
            jdata.BucketedLoader(ds_j, collate_fn=collate_j, **kw))


def test_bucketed_and_prefetch_loaders(corpora):
    """The same batches, pad masks and order over two shuffled epochs, for
    the global batch and for process 1 of 2; ``collate_tv`` over HPRC
    items; ``PrefetchLoader`` gives the same batches and raises the
    loader's error."""
    csv_path = corpora["jax_cp"]
    df = pd.read_csv(csv_path)
    vocab = jdata.build_vocab(df.phonemes)
    ds_t = tcp.CommonPhoneDataset(read_rows(csv_path), vocab)
    ds_j = jcp.CommonPhoneDataset(df, vocab)
    for kw in (dict(), dict(process_index=1, process_count=2)):
        lt, lj = _loaders(ds_t, ds_j, tdata.collate_ctc, jdata.collate_ctc,
                          batch_size=4, shuffle=True, seed=3, **kw)
        assert len(lt) == len(lj) == 3
        for _ in range(2):
            got, want = list(lt), list(lj)
            assert len(got) == len(want) >= 3
            _same(got, want)
        assert any(not b["batch_pad_mask"].all() for b in got)
    with pytest.raises(ValueError, match="divisible"):
        tdata.BucketedLoader(ds_t, 5, tdata.collate_ctc, process_count=2)

    h_csv = corpora["jax_hprc"]
    hv = jdata.build_vocab(pd.read_csv(h_csv).phoneme_labels)
    lt, lj = _loaders(thprc.HPRCDataset(read_rows(h_csv), hv, "both"),
                      jhprc.HPRCDataset(pd.read_csv(h_csv), hv, "both"),
                      tdata.collate_tv, jdata.collate_tv, batch_size=4,
                      shuffle=True, seed=1)
    got = list(tdata.PrefetchLoader(lt))
    _same(got, list(lj))
    assert {"tv_targets", "phn_frames", "frame_lengths"} <= got[0].keys()

    def broken():
        yield from list(lj)[:1]
        raise OSError("unreadable wav")

    seen = []
    with pytest.raises(OSError, match="unreadable"):
        for batch in tdata.PrefetchLoader(broken()):
            seen.append(batch)
    assert len(seen) == 1


def _split_manifest(tmp_path):
    """24 HPRC-style rows (4 speakers × 4 texts × N/F, some F rows
    missing), in a shuffled order, written by pandas."""
    rng = np.random.default_rng(5)
    rows = [{"index": 0, "path_wav": f"/c/{spk}_{t}_{rate}.wav",
             "speaker": spk, "text": f"text {t}", "rate": rate}
            for spk in ("M01", "F01", "M02", "F02") for t in range(4)
            for rate in ("N", "F")]
    rows = [r for i, r in enumerate(rows) if not (r["rate"] == "F"
                                                  and i % 5 == 1)]
    rows = [rows[i] for i in rng.permutation(len(rows))]
    for i, r in enumerate(rows):
        r["index"] = i
    path = tmp_path / "split.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


@pytest.mark.parametrize("rate,fraction,seed", [
    ("N", 0.1, 0), ("F", 0.5, 3), ("both", 0.25, 7), ("both", 0.0, 0)])
def test_loso_split_matches_jax(tmp_path, rate, fraction, seed):
    """The same rows in the same order in each of the four sets, from the
    same seeded draw of validation texts (the one-text floor at 0.1 of
    four texts; none at a fraction of 0)."""
    path = _split_manifest(tmp_path)
    rows, df = read_rows(path), pd.read_csv(path)
    for spk in ("M01", "F02"):
        got = thprc.loso_split(rows, spk, rate, fraction, seed)
        want = jhprc.loso_split(df, spk, rate, fraction, seed)
        for g, w in zip(got, want, strict=True):
            assert [r["path_wav"] for r in g] == list(w.path_wav)
        assert len(got[1]) > 0 or fraction == 0
        assert len(got[2]) + len(got[3]) > 0
    with pytest.raises(ValueError, match="train_val_rate"):
        thprc.loso_split(rows, "M01", "X")


def test_trim_csv_and_manifest_round_trip(tmp_path):
    """``trim_csv`` draws the rows pandas' ``sample(n, random_state=seed)``
    draws, in its order; a manifest the port writes reads back in pandas
    to the values pandas wrote."""
    rng = np.random.default_rng(6)
    rows = [{"index": i, "lang": "en", "path": f"/w/{i}.wav",
             "speaker": int(rng.integers(0, 4)),
             "text": "a, \"quoted\" text" if i % 3 else "",
             "phonemes": "(...) a k (...)",
             "phoneme_timestamps": [(0.0, 0.1 * i), (0.1 * i, 1.0)],
             "split": ("train", "val", "test")[i % 3]}
            for i in range(30)]
    pandas_csv, port_csv = tmp_path / "cp_p.csv", tmp_path / "cp_t.csv"
    pd.DataFrame(rows).to_csv(pandas_csv, index=False)
    write_rows(port_csv, rows)
    assert port_csv.read_bytes() == pandas_csv.read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(port_csv),
                                  pd.read_csv(pandas_csv))
    for seed in (0, 2):
        want = pd.read_csv(jcp.trim_csv(pandas_csv, 6, 3, 2, seed=seed))
        got = pd.read_csv(tcp.trim_csv(port_csv, 6, 3, 2, seed=seed))
        pd.testing.assert_frame_equal(got, want)
        assert list(want.split) == ["train"] * 6 + ["val"] * 3 + ["test"] * 2


def _corpus_tree(root):
    """A CommonPhone corpus directory (en: per-split csvs, wavs, MAUS
    grids), as ``tests/test_data.py`` builds one."""
    from aptai_tpu_torch.data.audio_io import save_wav
    from aptai_tpu_torch.data.textgrid import Interval, write_textgrid

    cp = root / "CP"
    (cp / "en" / "wav").mkdir(parents=True)
    (cp / "en" / "grids").mkdir(parents=True)
    rng = np.random.default_rng(0)
    splits = {"train": [], "dev": [], "test": []}
    for i, split in enumerate(["train", "train", "dev", "test", "train"]):
        name = f"utt_{i}"
        save_wav(cp / "en" / "wav" / f"{name}.wav",
                 (0.1 * rng.standard_normal(8000)).astype(np.float32), 16000)
        write_textgrid(cp / "en" / "grids" / f"{name}.TextGrid", {
            "MAU": [Interval(0.0, 0.2, "(...)"), Interval(0.2, 0.5, "a")],
            "ORT-MAU": [Interval(0.0, 0.5, f"word{i}")],
        })
        splits[split].append({"audio file": f"{name}.mp3",
                              "id": f"spk{i % 3}"})
    for split, data in splits.items():
        write_rows(cp / "en" / f"{split}.csv", data)
    return cp


def test_commonphone_csv_and_remap_speakers_match_jax(tmp_path):
    cp = _corpus_tree(tmp_path)
    out = cp.parent / "commonphone.csv"
    want = pd.read_csv(jcp.commonphone_csv(str(cp), langs=["en"]))
    shutil.move(out, tmp_path / "jax.csv")
    got_path = tcp.commonphone_csv(cp, langs=["en"])
    assert got_path == out
    pd.testing.assert_frame_equal(pd.read_csv(got_path), want)
    assert list(want.split) == ["train", "train", "train", "val", "test"]
    jcp.remap_speakers(tmp_path / "jax.csv")
    tcp.remap_speakers(got_path)
    pd.testing.assert_frame_equal(pd.read_csv(got_path),
                                  pd.read_csv(tmp_path / "jax.csv"))
    # first appearance: train utt_0, utt_1, utt_4, then dev, test
    assert [r["speaker"] for r in read_rows(got_path)] == ["0", "1", "1",
                                                           "2", "0"]
    with pytest.raises(ValueError, match="languages"):
        tcp.commonphone_csv(cp, langs=["xx"])
