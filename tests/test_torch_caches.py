"""aptai_tpu_torch's training caches against the JAX package's, float32 on
the CPU, over a synthetic HPRC corpus the port writes once per module
(3 speakers × 1 text × 2 rates) and both packages read:

* ``FECachedLoader``: the frozen feature extractor's batches over two
  shuffled epochs equal the JAX ``FECachedLoader``'s (features within
  1e-5 of their largest magnitude: float32 convolutions in other
  summation orders; labels, lengths and masks equal), with the fused
  flag off and on (the JAX fused kernel in interpret mode);
* ``FrozenEncodedLoader``, ``EncodedItemsLoader`` and
  ``FrozenEncodedCorpus.loader_for`` equal the JAX ones on a tiny FORCE
  tower, greedy and ``beam_device`` (frame embeddings within 1e-4 of
  their largest magnitude, as ``tests/test_torch_force.py`` holds the
  tower; sequences, labels and lengths equal);
* an APTAI ``TrainStep`` from the FE cache equals the step from audio at
  equal pad widths (loss and every parameter after it: same values,
  same operations after the extractor).
"""

import copy

import numpy as np
import pandas as pd
import pytest
import torch

from aptai_tpu.data import BucketedLoader as JaxLoader
from aptai_tpu.data import HPRCDataset as JaxHPRC
from aptai_tpu.data import collate_tv as jax_collate_tv
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.train import fe_cache as jfe
from aptai_tpu.train import frozen_cache as jfrozen
from aptai_tpu_torch.data import (BucketedLoader, HPRCDataset, build_vocab,
                                  collate_tv, make_synthetic_hprc)
from aptai_tpu_torch.data.hprc import loso_split
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_force_aptai
from aptai_tpu_torch.models import wav2vec2 as tw2v
from aptai_tpu_torch.models.convert import w2v2_pr_state_dict_from_jax
from aptai_tpu_torch.train import (EncodedItemsLoader, FECachedLoader,
                                   FrozenEncodedCorpus, FrozenEncodedLoader,
                                   TrainStep, aptai_loss_fn, torch_adam)
from aptai_tpu_torch.train.fe_cache import collate_fe

from _torch_port import (NO_DROP, one_torch_thread, port_aptai_from_jax,
                         random_jax_aptai_params, random_jax_w2v2_pr_params)

# the 7-layer conv stack (49 frames a second), 128 channels so the fused
# layers apply
STACK = dict(conv_dim=(128,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11  # the synthetic corpus's vocabulary, blank included


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = make_synthetic_hprc(tmp_path_factory.mktemp("hprc"), 1,
                               ("M01", "F02", "M03"), device="cpu")
    rows = read_rows(path)
    return path, rows, build_vocab(r["phoneme_labels"] for r in rows)


def _tv_loaders(corpus, batch_size=4):
    """The same unshuffled ``collate_tv`` batches in both packages."""
    path, rows, vocab = corpus
    return (BucketedLoader(HPRCDataset(rows, vocab, "both"), batch_size,
                           collate_tv, shuffle=False),
            JaxLoader(JaxHPRC(pd.read_csv(path), vocab, "both"), batch_size,
                      jax_collate_tv, shuffle=False))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _same_batches(got, want, float_keys, tol):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in float_keys:
                _close(g[k], w[k], tol, k)
            elif k == "utt_keys":
                assert list(g[k]) == list(w[k])
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_fe_cached_loader_matches_jax(corpus, monkeypatch, fused):
    if fused:
        from jax.experimental import pallas as pl

        real = pl.pallas_call  # the JAX op passes interpret=False itself
        monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: real(
            *a, **{**kw, "interpret": True}))
        monkeypatch.setattr(
            jw2v, "_fused_fe_applicable",
            lambda cfg, k, s, c: tw2v._fused_fe_applicable(cfg, k, s, c))
    cfg_t = tcfg.tiny_config(**STACK, **NO_DROP,
                             fused_feature_extractor=fused)
    params = random_jax_aptai_params(cfg_t, V, seed=3)
    model = port_aptai_from_jax(cfg_t, params, V)
    cfg_j = jcfg.tiny_config(**STACK, **NO_DROP,
                             fused_feature_extractor=fused)
    jfe._fe_fn.cache_clear()  # trace under this test's patches
    loader_t, loader_j = _tv_loaders(corpus)
    calls = []
    if fused:
        from aptai_tpu_torch.ops import fused_conv

        real_plain = fused_conv.fused_conv_ln_gelu_plain
        monkeypatch.setattr(fused_conv, "fused_conv_ln_gelu_plain",
                            lambda *a, **kw: calls.append(1) or real_plain(
                                *a, **kw))
    got = FECachedLoader(loader_t, model, seed=5)
    want = jfe.FECachedLoader(loader_j, cfg_j,
                              params["encoder"]["feature_extractor"], seed=5)
    assert len(calls) == (6 * len(loader_t) if fused else 0)
    assert got.cache_bytes == want.cache_bytes > 0
    for _ in range(2):
        _same_batches(list(got), list(want), ("fe_features",), 1e-5)
    jfe._fe_fn.cache_clear()


def _force_pair(method):
    """A tiny FORCE tower from ``_torch_port`` in both packages (the JAX
    cache pass applies the tower only) and the port's model around it."""
    cfg_t = tcfg.tiny_config(**STACK, **NO_DROP, vocab_size=V)
    tower = random_jax_w2v2_pr_params(cfg_t, seed=21)
    jax_model = JaxForceAPTAI(jcfg.tiny_config(**STACK, **NO_DROP,
                                               vocab_size=V),
                              vocab_size=V, decode_method=method)
    model = random_force_aptai(cfg_t, seed=2, vocab_size=V,
                               decode_method=method)
    model.w2v2_pr.load_state_dict(w2v2_pr_state_dict_from_jax(tower))
    return model.eval(), jax_model, {"w2v2_pr": tower}


ENCODED_FLOATS = ("frame_embs", "tv_targets")


@pytest.mark.parametrize("method", ["greedy", "beam_device"])
def test_frozen_encoded_loaders_match_jax(corpus, method):
    """``FrozenEncodedLoader`` over a fold's batches, and
    ``FrozenEncodedCorpus`` over the manifest with ``loader_for`` a LOSO
    fold's training rows, each over two shuffled epochs; the cached items
    equal, and ``EncodedItemsLoader`` over them."""
    model, jax_model, jax_params = _force_pair(method)
    loader_t, loader_j = _tv_loaders(corpus, batch_size=3)
    got = FrozenEncodedLoader(loader_t, model, seed=7)
    want = jfrozen.FrozenEncodedLoader(loader_j, jax_model, jax_params,
                                       seed=7)
    assert got.cache_bytes == want.cache_bytes
    items = got.dataset.items
    assert len(items) == 6 and any(it["phn_seq_length"] for it in items)
    for _ in range(2):
        _same_batches(list(got), list(want), ENCODED_FLOATS, 1e-4)

    path, rows, vocab = corpus
    train_rows = loso_split(rows, "M03", "both", 0.0)[0]
    # the fold loader's batch size: the JAX pass reuses its programs
    corpus_t = FrozenEncodedCorpus(rows, vocab, model, batch_size=3)
    corpus_j = jfrozen.FrozenEncodedCorpus(pd.read_csv(path), vocab,
                                           jax_model, jax_params, 3)
    assert len(corpus_t) == len(corpus_j) == len(rows)
    fold_t = corpus_t.loader_for(train_rows, 2, seed=1)
    fold_j = corpus_j.loader_for(pd.DataFrame(train_rows), 2, seed=1)
    assert len(fold_t.dataset) == 4
    for _ in range(2):
        _same_batches(list(fold_t), list(fold_j), ENCODED_FLOATS, 1e-4)
    again = EncodedItemsLoader(items, 4, shuffle=False)
    _same_batches(list(again), list(jfrozen.EncodedItemsLoader(
        want.dataset.items, 4, shuffle=False)), ENCODED_FLOATS, 1e-4)


def test_aptai_step_from_fe_cache_equals_step_from_audio(corpus):
    """One ``collate_tv`` batch without bucketing and the FE cache's batch
    of the same items without bucketing have one frame width; the Adam
    step from each (dropout and SpecAugment on, seeded alike) gives the
    same loss and parameters."""
    cfg = tcfg.tiny_config(**STACK)
    params = random_jax_aptai_params(cfg, V, seed=4)
    model = port_aptai_from_jax(cfg, params, V)
    path, rows, vocab = corpus
    ds = HPRCDataset(rows, vocab, "both")
    batch = collate_tv([ds[i] for i in range(4)], bucket=False)

    class OneBatch(list):
        batch_size = 4

    cache = FECachedLoader(OneBatch([batch]), model, shuffle=False)
    fe_batch = collate_fe(cache.dataset.items, bucket=False)
    assert fe_batch["fe_features"].shape[1] == batch["tv_targets"].shape[1]
    results = []
    for feats in (False, True):
        m = copy.deepcopy(model)
        step = TrainStep(m, torch_adam(m), aptai_loss_fn(feats),
                         device="cpu", seed=3)
        out = step(fe_batch if feats else batch, 1e-3)
        results.append((out["loss"].item(), m.state_dict()))
    (loss_a, sd_a), (loss_f, sd_f) = results
    assert loss_a == loss_f and np.isfinite(loss_a)
    moved = 0
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_f[k]), k
        moved += not torch.equal(sd_a[k], model.state_dict()[k])
    assert moved > 10
