"""aptai_tpu_torch's serving wire formats (``infer/serve.py``) against the
JAX package's, on the CPU: ``decode_wire_audio`` gives the JAX
function's samples byte for byte (or its error), for each encoding and
JSON bodies; ``encode_binary`` writes the JAX bytes and each package's
``decode_binary`` reads the other's.
"""

import json

import numpy as np
import pytest

from aptai_tpu.infer import serve as jserve
from aptai_tpu.infer.api import quantize_transfer
from aptai_tpu_torch.infer import serve as tserve

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _wav(n, seed):
    return (np.random.default_rng(seed).standard_normal(n)
            .astype(np.float32) * 0.1)


# -- the wire -----------------------------------------------------------------

def _wire_cases():
    wav = _wav(3000, 62)
    return {
        "float32": (wav.tobytes(), "", None, None),
        "float32_named": (wav.tobytes(), "application/octet-stream",
                          "float32", "16000"),
        "int16": (quantize_transfer(wav, "int16").tobytes(), "", "int16",
                  None),
        "mulaw": (quantize_transfer(wav, "uint8_mulaw").tobytes(), "",
                  "uint8_mulaw", None),
        "json": (json.dumps({"audio": wav[:50].tolist()}).encode(),
                 "application/json; charset=utf-8", None, None),
        "json_bad": (b"{\"audio\": [1, 2", "application/json", None, None),
        "json_nested": (b"{\"audio\": [[1, 2]]}", "application/json", None,
                        None),
        "json_no_key": (b"{\"x\": 1}", "application/json", None, None),
        "empty": (b"", "", None, None),
        "bad_encoding": (b"\x00" * 8, "", "pcm24", None),
        "bad_rate": (wav.tobytes(), "", "float32", "8000"),
        "too_long": (np.zeros(2 * 16_000, np.float32).tobytes(), "", None,
                     None),
    }


@pytest.mark.parametrize("case", list(_wire_cases()))
def test_decode_wire_audio_matches_jax(case):
    args = _wire_cases()[case] + (1.0,)
    try:
        want = jserve.decode_wire_audio(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tserve.decode_wire_audio(*args)
        assert str(got.value) == str(e)
        return
    got = tserve.decode_wire_audio(*args)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_binary_frames_match_jax_byte_for_byte():
    rng = np.random.default_rng(63)
    payload = {"frames": 7, "tvs_pred": {k: rng.standard_normal(7).astype(
        np.float32) for k in ("LA", "LP")},
        "phn_fc_pred": rng.integers(0, 9, 7).astype(np.int32),
        "phn_seq_dur": rng.random(3).astype(">f4"),  # big-endian in
        "ids": np.arange(4, dtype=np.int64), "empty": np.zeros((0, 3)),
        "ipa": ["a", "b"], "nested": {"x": 1.5, "y": [np.int64(2)]}}
    data = tserve.encode_binary(payload)
    assert data == jserve.encode_binary(payload)
    for dec in (tserve.decode_binary, jserve.decode_binary):
        back = dec(data)
        assert back["frames"] == 7 and back["ipa"] == ["a", "b"]
        assert back["nested"] == {"x": 1.5, "y": [2]}
        np.testing.assert_array_equal(back["tvs_pred"]["LP"],
                                      payload["tvs_pred"]["LP"])
        np.testing.assert_array_equal(back["phn_seq_dur"],
                                      payload["phn_seq_dur"])
    assert tserve.jsonify(payload) == jserve.jsonify(payload)
    with pytest.raises(ValueError, match="ATB1"):
        tserve.decode_binary(b"JSON{}...")
    assert tserve.WIRE_ENCODINGS == jserve.WIRE_ENCODINGS
    assert tserve.KIND_FIELDS == jserve.KIND_FIELDS
    assert tserve.STREAMER_CLASSES == jserve.STREAMER_CLASSES
    lut = np.arange(256, dtype=np.uint8)
    assert (tserve._mulaw_expand_host(lut).tobytes()
            == jserve._mulaw_expand_host(lut).tobytes())
