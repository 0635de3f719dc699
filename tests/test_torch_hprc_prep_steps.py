"""aptai_tpu_torch's HPRC preparation step by step against the JAX
package's: the four TV normalisations over one tree's TVs (host numpy,
so bit for bit), the ``.mat`` cell nestings and F02's layout, the EMA
low-pass and the other host functions, the CLI's ``--platform``, and the
MAUS client with its HTTP layer stubbed at the ``requests`` module (no
network), as ``tests/test_maus.py`` stubs it.
"""

import pickle
import shutil
import sys

import numpy as np
import pytest
import requests
import torch

from aptai_tpu.data import hprc_prep as jprep
from aptai_tpu_torch.data import hprc_prep as tprep
from aptai_tpu_torch.data.synthetic import make_synthetic_hprc_raw

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def tv_tree(tmp_path_factory):
    """Three speakers' raw tree taken through extraction, the low-pass and
    the TVs (host steps only) by the port."""
    root = tmp_path_factory.mktemp("steps")
    make_synthetic_hprc_raw(root / "raw", speakers=("M01", "F01", "F02"),
                            texts=2, repetitions=("R01",), seconds=(0.6, 1.4),
                            fs=16_000, seed=5)
    prep = tprep.extract_mat(root / "raw", root / "prep")
    assert tprep.write_lowpass_ema(prep) == 15
    assert tprep.write_tvs(prep) == 12
    return prep


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_tvs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("scheme,rate", [
    ("zscore_utterance", "both"), ("minmax_speaker", "both"),
    ("zscore_speaker", "both"), ("minmax_zscore_global", "both"),
    ("minmax_zscore_global", "N")])
def test_normalisations_match_jax(tv_tree, tmp_path, scheme, rate):
    """``write_tv_norm`` of both packages over copies of one tree's TVs,
    every pickle bit for bit; the scheme's functions called directly too
    (the global stats from N-rate utterances only under ``rate="N"``, which
    changes them)."""
    trees = {}
    for side in ("port", "jax"):
        trees[side] = tmp_path / side
        for spk in ("M01", "F01", "F02"):
            shutil.copytree(tv_tree / spk / "tvs", trees[side] / spk / "tvs")
    assert tprep.write_tv_norm(trees["port"], scheme, rate) == 12
    assert jprep.write_tv_norm(trees["jax"], scheme, rate) == 12
    for pkl in sorted(trees["port"].glob("*/tvs_norm/*.pkl")):
        _same_tvs(_load(pkl), _load(trees["jax"] / pkl.relative_to(
            trees["port"])))
    pkls = sorted(tv_tree.glob("*/tvs/*.pkl"))
    tvs = [_load(p) for p in pkls]
    rates = [p.stem[-1] for p in pkls]
    if scheme == "minmax_zscore_global":
        got = tprep.global_stats(tvs, rates, rate)
        assert got == jprep.global_stats(tvs, rates, rate)
        assert (got == tprep.global_stats(tvs, rates, "both")) == (
            rate == "both")
        _same_tvs(tprep.minmax_zscore_global(tvs[0], *got),
                  jprep.minmax_zscore_global(tvs[0], *got))
    elif scheme != "zscore_utterance":
        stats = tprep.speaker_stats(tvs[:4])
        assert stats == jprep.speaker_stats(tvs[:4])
        args = stats[:2] if scheme == "minmax_speaker" else stats[2:]
        _same_tvs(getattr(tprep, scheme)(tvs[0], *args),
                  getattr(jprep, scheme)(tvs[0], *args))
    else:
        _same_tvs(tprep.zscore_utterance(tvs[0]),
                  jprep.zscore_utterance(tvs[0]))
    with pytest.raises(ValueError, match="no utterances"):
        tprep.global_stats(tvs[:1], ["F"], "N")


def test_mat_cells_and_the_f02_layout(tv_tree):
    """``_cell_field`` over the nestings scipy gives a cell ((3,), (1, 3),
    (3, 1), ``np.void``) equals the JAX function's; F02's EMA skips ML and
    takes JAW / JAWL from the columns left of M01's."""
    import scipy.io

    cell = np.empty((3,), dtype=object)
    cell[0], cell[1], cell[2] = "TT", np.array([[100]]), np.arange(6.0)
    void = np.zeros((), dtype=[("NAME", object), ("SRATE", object),
                               ("SIGNAL", object)])[()]
    void["NAME"], void["SRATE"], void["SIGNAL"] = cell
    for c in (cell, cell.reshape(1, 3), cell.reshape(3, 1), void):
        for i in range(3):
            got, want = tprep._cell_field(c, i), jprep._cell_field(c, i)
            assert type(got) is type(want)
            np.testing.assert_array_equal(got, want)
    raw = tv_tree.parent / "raw"
    key = "F02_B01_S01_R01_N"
    data = scipy.io.loadmat(raw / "F02" / "data" / f"{key}.mat")[key]
    assert data.shape == (1, 8)
    ema = _load(tv_tree / "F02" / "ema" / f"{key}.pkl")
    assert list(ema) == ["TR", "TB", "TT", "UL", "LL", "JAW", "JAWL"]
    np.testing.assert_array_equal(
        ema["JAW"]["x"], np.asarray(tprep._cell_field(data[0, 6], 2))[:, 0])
    m01 = _load(tv_tree / "M01" / "ema" / "M01_B01_S01_R01_N.pkl")
    assert list(m01) == list(tprep.EMA_SENSORS)


def test_host_functions_match_jax(tv_tree):
    """The low-pass (nested sensor dicts with interior and trailing NaNs,
    the palate's flat dict), ``butter_lowpass``, the sensor medians,
    ``compute_tvs``, the Gaussian smoothing, ``mspec_znorm``, the NCCF F0
    and ``compute_f0_rapt`` without ``pysptk``, bit for bit."""
    ema = _load(tv_tree / "M01" / "ema" / "M01_B02_S01_R01_F.pkl")
    palate = _load(tv_tree / "M01" / "ema" / "M01_palate.pkl")
    assert np.isnan(ema["TT"]["x"]).any() and np.isnan(ema["TT"]["z"]).any()
    for d in (ema, palate):
        got, want = tprep.lowpass_ema_dict(d), jprep.lowpass_ema_dict(d)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], dict):
                _same_tvs(got[k], want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k])
    x = np.asarray(palate["z"], np.float64)
    np.testing.assert_array_equal(tprep.butter_lowpass(x, 5.0, 100.0, 3),
                                  jprep.butter_lowpass(x, 5.0, 100.0, 3))
    emas = [_load(p) for p in sorted((tv_tree / "F01" / "ema_low").glob(
        "F01_B*.pkl"))]
    medians = {f"median_{s.lower()}x": tprep.median_sensor_x(emas, s)
               for s in ("LL", "TT", "TB", "TR")}
    assert medians == {f"median_{s.lower()}x": jprep.median_sensor_x(emas, s)
                       for s in ("LL", "TT", "TB", "TR")}
    pal = _load(tv_tree / "F01" / "ema_low" / "F01_palate.pkl")
    tvs = tprep.compute_tvs(emas[0], pal, **medians)
    _same_tvs(tvs, jprep.compute_tvs(emas[0], pal, **medians))
    _same_tvs(tprep.gaussian_smooth_tvs(tvs, 1.5),
              jprep.gaussian_smooth_tvs(tvs, 1.5))
    rng = np.random.default_rng(0)
    mspec = rng.standard_normal((40, 80)).astype(np.float32)
    got = tprep.mspec_znorm(mspec)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jprep.mspec_znorm(mspec))
    t = np.arange(8000) / 16_000
    wav = (0.3 * np.sin(2 * np.pi * 180.0 * t)
           + 0.01 * rng.standard_normal(8000)).astype(np.float32)
    for spk in ("M01", "F03"):
        got = tprep.compute_f0_rapt(wav, spk)
        assert got.dtype == np.float64 and len(got) == 1 + 8000 // 256
        np.testing.assert_array_equal(got, jprep.compute_f0_rapt(wav, spk))
    assert "pysptk" not in sys.modules


def test_audio_duration_range_matches_jax(tmp_path):
    """Shortest and longest utterance of a manifest, read without
    pandas."""
    from aptai_tpu_torch.data.synthetic import make_synthetic_hprc

    csv_path = make_synthetic_hprc(tmp_path, 1, ("M01", "F01"),
                                   device="cpu")
    got = tprep.audio_duration_range(csv_path)
    assert got == jprep.audio_duration_range(csv_path)
    assert 0 < got[0] < got[1]


def test_cli_on_the_cpu(tmp_path, capsys):
    """``main`` with ``--platform cpu`` prepares a raw tree with a
    normalisation other than the default; a second run with ``--replace``
    rewrites every pickle to the same values."""
    make_synthetic_hprc_raw(tmp_path / "raw", speakers=("M02",), texts=1,
                            seconds=(0.8, 0.8), fs=16_000, seed=1,
                            phonemes_root=tmp_path / "prep")
    argv = [str(tmp_path / "raw"), "--prep", str(tmp_path / "prep"),
            "--norm", "minmax_zscore_global", "--norm_rate", "F",
            "--platform", "cpu"]
    tprep.main(argv)
    out = capsys.readouterr().out
    assert "[6/8] TV normalization (minmax_zscore_global, rate=F)" in out
    assert " on cpu in " in out
    first = {p: _load(p) for p in (tmp_path / "prep").rglob("*.pkl")}
    assert len(first) == 2 + 4 * 9  # palates; 4 utterances × 9 folders
    tprep.main(argv[1:] + ["--replace", "--vocab",
                           str(tmp_path / "prep" / "vocab.json")])
    out = capsys.readouterr().out
    assert "[1/8] extract_mat skipped" in out and "      4 utterances" in out
    for p, value in first.items():
        got = _load(p)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got, value)
        else:
            assert pickle.dumps(got) == pickle.dumps(value), p


def test_cli_refuses_an_unknown_platform_and_never_falls_back(
        tmp_path, monkeypatch, capsys):
    """``--platform tpu`` is an argument error naming the platforms; the
    default, ``auto``, is the card, and without one the run raises before
    it writes anything."""
    with pytest.raises(SystemExit) as exc:
        tprep.main(["--prep", str(tmp_path), "--platform", "tpu"])
    assert exc.value.code == 2
    assert "('auto', 'cpu')" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprep.main(["--prep", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprep.compute_utterance_mspec(np.zeros(4000, np.float32))
    assert list(tmp_path.iterdir()) == []


_LINK_XML = ("<WebServiceResponseLink><success>true</success>"
             "<downloadLink>https://bas.example/dl/job7.TextGrid"
             "</downloadLink></WebServiceResponseLink>")


class _Resp:
    def __init__(self, status_code=200, text="", content=b""):
        self.status_code = status_code
        self.text = text
        self.content = content or text.encode()

    def raise_for_status(self):
        if self.status_code >= 400:
            raise requests.HTTPError(f"status {self.status_code}")


def test_maus_g2p_posts_the_pipeline_and_refuses_high_load(
        tmp_path, monkeypatch):
    """The same GET, multipart POST and link as the JAX client's; a load
    indicator of 2 refuses before the POST; an HTTP error raises."""
    wav, txt = tmp_path / "a.wav", tmp_path / "a.txt"
    wav.write_bytes(b"RIFF")
    txt.write_text("hello")
    for pkg in (tprep, jprep):
        posted, urls = {}, []
        monkeypatch.setattr(requests, "get", lambda url, **kw: (
            urls.append(url), _Resp(text="0"))[1])
        monkeypatch.setattr(requests, "post", lambda url, files=None, **kw: (
            urls.append(url), posted.update(
                {k: v for k, v in files.items() if isinstance(v, tuple)}),
            _Resp(text=_LINK_XML))[2])
        assert pkg.maus_g2p(wav, txt, "deu") == (
            "https://bas.example/dl/job7.TextGrid")
        assert posted["LANGUAGE"] == (None, "deu")
        posts = (urls, posted)
        if pkg is tprep:
            port_posts = posts
    assert port_posts == posts
    monkeypatch.setattr(requests, "get", lambda *a, **k: _Resp(text="2\n"))
    monkeypatch.setattr(requests, "post", lambda *a, **k: pytest.fail(
        "no POST under high load"))
    with pytest.raises(RuntimeError, match="load"):
        tprep.maus_g2p(wav, txt)
    monkeypatch.setattr(requests, "get", lambda *a, **k: _Resp(text="0"))
    monkeypatch.setattr(requests, "post",
                        lambda *a, **k: _Resp(status_code=500, text="x"))
    with pytest.raises(requests.HTTPError):
        tprep.maus_g2p(wav, txt)


def test_run_maus_alignment_walks_and_skips_existing(tmp_path, monkeypatch):
    """Every wav without a TextGrid is aligned and its TextGrid downloaded;
    one that exists is kept unless ``replace``."""
    for spk, utts in (("F01", ["u1", "u2"]), ("M02", ["u3"])):
        (tmp_path / spk / "audio").mkdir(parents=True)
        (tmp_path / spk / "text").mkdir()
        for utt in utts:
            (tmp_path / spk / "audio" / f"{utt}.wav").write_bytes(b"RIFF")
            (tmp_path / spk / "text" / f"{utt}.txt").write_text("a word")
    (tmp_path / "F01" / "phonemes").mkdir()
    (tmp_path / "F01" / "phonemes" / "u1.TextGrid").write_text("EXISTING")
    downloads = []

    def fake_get(url, **kw):
        if url.endswith("/getLoadIndicator"):
            return _Resp(text="0")
        downloads.append(url)
        return _Resp(text="TEXTGRID")

    monkeypatch.setattr(requests, "get", fake_get)
    monkeypatch.setattr(requests, "post",
                        lambda *a, **k: _Resp(text=_LINK_XML))
    assert tprep.run_maus_alignment(tmp_path) == 2
    assert (tmp_path / "F01" / "phonemes" / "u1.TextGrid").read_text() \
        == "EXISTING"
    assert (tmp_path / "M02" / "phonemes" / "u3.TextGrid").read_text() \
        == "TEXTGRID"
    assert tprep.run_maus_alignment(tmp_path) == 0
    assert tprep.run_maus_alignment(tmp_path, replace=True) == 3
    assert len(downloads) == 5


def test_maus_without_requests_names_the_package(tmp_path, monkeypatch):
    """With ``requests`` absent, both MAUS functions raise an
    ``ImportError`` that names it; the other steps do not need it."""
    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(ImportError, match="'requests' package"):
        tprep.maus_g2p(tmp_path / "a.wav", tmp_path / "a.txt")
    with pytest.raises(ImportError, match="'requests' package"):
        tprep.run_maus_alignment(tmp_path)
    assert tprep.write_lowpass_ema(tmp_path) == 0
