"""The plain reference against the program at a tiny size on the CPU: in
float32 they compute the same model, so they agree to float32 round-off;
the traffic is the same for a seed and differs between seeds."""

import numpy as np
import pytest
import torch

from port_bench import data
from port_bench.reference.encoder import predict
from port_bench.tests.tiny import tiny_config
from port_bench.traffic.train_steps import make_batch
from port_bench.weights import build_model, seed_weights


def test_generators_repeat_per_seed():
    def draw(seed):
        rng = np.random.default_rng(seed)
        lengths = data.stratified_lengths(64, 1.0, 10.0, rng)
        wavs = data.waveforms(lengths, rng)
        cfg = tiny_config("w2v2pr-large")
        batch = make_batch(cfg, wavs[:4], rng, 12.0)
        return lengths, wavs, batch

    a, b, c = draw(5), draw(5), draw(6)
    assert np.array_equal(a[0], b[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert all(np.array_equal(a[2][k], b[2][k]) for k in a[2])
    # another seed: the same sizes, in another order
    assert not np.array_equal(a[0], c[0])
    assert np.array_equal(np.sort(a[0]), np.sort(c[0]))


@pytest.mark.parametrize("name", ["aptai-large", "w2v2pr-large"])
def test_reference_forward_matches_program(name, one_thread):
    cfg = dict(tiny_config(name), dtype="float32")
    model = build_model(cfg, "cpu").eval()
    weights = seed_weights(model, 3)
    rng = np.random.default_rng(0)
    lengths = np.array([16000, 9000, 4000])
    audio = torch.from_numpy(data.padded(data.waveforms(lengths, rng),
                                         16000))
    lens = torch.from_numpy(lengths)
    from port_bench.reference.encoder import Ops, encode, pr_head

    with torch.no_grad():
        h_ref, flen = encode(weights, cfg, audio, lens, Ops())
        if name == "aptai-large":
            got = model.predict(audio, lens,
                                fields=("tvs_pred", "phn_fc_logits"))
            want = predict(weights, cfg, audio, lens)
            pairs = [(got[k], want[k]) for k in ("tvs_pred",
                                                 "phn_fc_logits")]
        else:
            got = model.encode(audio, lens)
            pairs = [(got["phoneme_logits"], pr_head(weights, h_ref, Ops()))]
    assert torch.equal(got["frame_lengths"].long(), flen.long())
    for a, b in pairs:
        for i, n in enumerate(flen.tolist()):
            err = (a[i, :n] - b[i, :n]).norm() / b[i, :n].norm()
            assert err < 1e-5


def test_fp8_control_departs(one_thread):
    """The control's products through float8 move the outputs by far more
    than float32 round-off."""
    cfg = dict(tiny_config("aptai-large"), dtype="float32")
    model = build_model(cfg, "cpu").eval()
    weights = seed_weights(model, 4)
    rng = np.random.default_rng(1)
    lengths = np.array([16000, 12000])
    audio = torch.from_numpy(data.padded(data.waveforms(lengths, rng),
                                         16000))
    lens = torch.from_numpy(lengths)
    a = predict(weights, cfg, audio, lens)
    b = predict(weights, cfg, audio, lens, precision="fp8")
    err = (a["tvs_pred"] - b["tvs_pred"]).norm() / a["tvs_pred"].norm()
    assert err > 1e-2
