"""aptai_tpu_torch's serving bundles (``infer/export.py``) against the JAX
package's, and the rest of their contract, float32 on the CPU:

* parity with the JAX package: the same weights exported by both
  packages, the same wavs through both bundles (TVs and logits within
  rtol 1e-4 / atol 1e-5, argmax and sequences equal);
* ``beam_host`` and the other export refusals, and an undeclared device
  refused.
"""

import numpy as np
import pytest
import torch

from aptai_tpu.infer import export as jexport
from aptai_tpu_torch.infer import export as texport
from aptai_tpu_torch.models import random_force_aptai
from aptai_tpu_torch.models import configs as tcfg

from _torch_port import jax_lstm_one_step_a_loop, one_torch_thread
from _torch_export_bundles import (BATCH, FIELDS, FRAME_FIELDS, SECONDS,
                                   STACK, V, _wavs, bundles, models)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.mark.parametrize("name", ["aptai", "w2v2_pr", "force_aptai"])
def test_bundle_matches_the_jax_packages_bundle(models, bundles, name,
                                                tmp_path, monkeypatch):
    """TVs and logits within rtol 1e-4 / atol 1e-5 (FORCE's TVs, after the
    BiLSTM, within 1e-4 of their largest magnitude, the gate of
    ``test_torch_force.py``); argmax, sequences and lengths equal."""
    jax_lstm_one_step_a_loop(monkeypatch)
    params, jmodel, tmodel, method = models[name]
    wavs = _wavs(seed=3)
    kw = dict(method=method, batch=BATCH, seconds=SECONDS,
              fields=FIELDS[name])
    jbundle = jexport.load_serving_bundle(jexport.save_serving_bundle(
        tmp_path / "jax", jmodel, params, platforms=("cpu",), **kw))
    want = {k: np.asarray(v) for k, v in jbundle.predict_batch(wavs).items()}
    tbundle = bundles[name][1] if name in bundles else \
        texport.load_serving_bundle(texport.save_serving_bundle(
            tmp_path / "port", tmodel, platforms=("cpu",), **kw),
            device="cpu")
    got = tbundle.predict_batch(wavs)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["frame_lengths"], want["frame_lengths"])
    for i, n in enumerate(want["frame_lengths"]):
        for k in got:
            g, w = got[k][i], want[k][i]
            if k in FRAME_FIELDS:  # valid frames
                g, w = g[:n], w[:n]
            if k == "tvs_pred" and name == "force_aptai":
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
            elif k in ("tvs_pred", "phoneme_logits"):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_export_refusals(models, tmp_path):
    _, _, model, _ = models["aptai"]
    with pytest.raises(ValueError, match="unknown output field"):
        texport.save_serving_bundle(tmp_path / "bad", model, batch=1,
                                    seconds=0.25, fields=("nope",),
                                    platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms"):
        texport.save_serving_bundle(tmp_path / "tpu", model, batch=1,
                                    seconds=0.25, platforms=("tpu",))
    beam = random_force_aptai(tcfg.tiny_config(**STACK), seed=0,
                              vocab_size=V, decode_method="beam_host")
    with pytest.raises(ValueError, match="beam_host"):
        texport.save_serving_bundle(tmp_path / "beam", beam, batch=1,
                                    seconds=0.25, platforms=("cpu",))
    assert not (tmp_path / "beam").exists()


def test_bundle_loads_only_on_a_declared_device(bundles, monkeypatch):
    d = bundles["aptai"][0]
    assert texport.is_bundle(d) and not texport.is_bundle(d.parent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_serving_bundle(d)  # cuda unless named

