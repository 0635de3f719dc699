"""aptai_tpu_torch's FORCE-APTAI against the JAX package, float32 on the
CPU, with a JAX parameter tree whose head ``ForceAPTAI.init`` made (noise
added to every leaf) crossed through ``force_aptai_state_dict_from_jax``:

* the full path (``predict``, ``get_alignment``, ``forward``), greedy, and
  ``frame_hidden_layer=1``;
* the head alone over the knob matrix (``train_from_encoded`` with its
  gradients, ``predict_from_encoded``, ``alignment_from_encoded``);
* ``beam_host`` through the split path and its gate;
* ``ForceAPTAIPredictor`` behind the ``MicroBatcher`` against the JAX
  predictor, and the ``beam_host`` predictor's real-rows-only decode;
* one ``TrainStep`` from audio and one from the frozen-tower cache;
* the evaluation forwards with ``validate_tv`` and ``ctc_seq_per``.

The config is tiny in width with the 7-layer conv stack (49 frames a
second). The JAX side runs its reference computations in a few compiled
programs and its native library switched off (the Python beam and edit
distance), so nothing builds inside the JAX tree. Tolerances: continuous
outputs within 1e-4 of their largest magnitude, losses within 1e-5
relative, integer outputs equal, head gradients at relative L2 ≤ 1e-4."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.decode import beam as jbeam
from aptai_tpu.decode import native as jnative
from aptai_tpu.infer.api import ForceAPTAIPredictor as JaxForcePredictor
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import evaluate as jeval
from aptai_tpu.train import train_force_aptai as jtrain
from aptai_tpu_torch.decode import native as tnative
from aptai_tpu_torch.infer import ForceAPTAIPredictor, MicroBatcher
from aptai_tpu_torch.models import (ForceAPTAI, force_aptai_state_dict_from_jax,
                                    random_force_aptai)
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.train import (TrainStep, collate_encoded, encode_items,
                                   force_loss_fn, torch_adam)
from aptai_tpu_torch.train import evaluate as teval
from aptai_tpu_torch.train import train_force_aptai as ttrain

from _torch_port import (jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_w2v2_pr_params)

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
# the defaults, and every knob away from its default at once
KNOBS = {"default": {},
         "knobs": dict(off_diag_prior=True, blank_logprob=-2.5,
                       energy_temperature=0.5, aux_frame_ce_weight=0.1)}
LOSSES = ("loss", "tv_loss", "align_loss", "aux_ce")
INTS = ("pred_frame_phns", "pred_ctc_phn_seq", "phn_seq_lengths",
        "phn_seq_truncated", "frame_lengths", "phn_pred_seq")


@pytest.fixture(autouse=True)
def _jax_without_native(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _audio_batch():
    """4 items of 2, 1.25, 0.56 and 1.63 s (99, 62, 27 and 81 frames),
    silent past their lengths, TV targets padded with −100 past them, and
    the metric keys (frame phonemes, labels)."""
    rng = np.random.default_rng(20)
    lens = np.array([32_000, 20_000, 9_000, 26_000], np.int32)
    audio = (rng.standard_normal((4, 32_000)) * 0.1).astype(np.float32)
    frames = tcfg.tiny_config(**STACK).feat_extract_output_lengths(lens)
    tv = rng.standard_normal((4, 99, 9)).astype(np.float32)
    phn_frames = rng.integers(1, V, (4, 99)).astype(np.int32)
    labels = np.full((4, 40), -100, np.int32)
    for b in range(4):
        audio[b, lens[b]:] = 0.0
        tv[b, frames[b]:] = -100.0
        phn_frames[b, frames[b]:] = 0
        n = rng.integers(5, 40)
        labels[b, :n] = rng.integers(1, V, n)
    return {"audio": audio, "audio_lengths": lens, "tv_targets": tv,
            "phn_frames": phn_frames, "frame_lengths": frames.astype(np.int32),
            "phoneme_labels": labels}


def _encoded_case():
    """Head inputs drawn with numpy: frame embeddings (4, 99, 32), frame
    counts 99, 62, 7, 80; sequences of 60 (cap hit, 5 cut), 20, 9 (more
    tokens than the 7 frames: infeasible for ForwardSum) and 0 tokens; TV
    targets padded past the frames; tower labels (0 = blank included)."""
    rng = np.random.default_rng(21)
    fl = np.array([99, 62, 7, 80], np.int32)
    sl = np.array([60, 20, 9, 0], np.int32)
    seq = np.zeros((4, 60), np.int32)
    for b in range(4):
        seq[b, :sl[b]] = rng.integers(1, V, sl[b])
    tv = rng.standard_normal((4, 99, 9)).astype(np.float32)
    for b in range(4):
        tv[b, fl[b]:] = -100.0
    return (rng.standard_normal((4, 99, 32)).astype(np.float32), fl, seq, sl,
            np.array([5, 0, 0, 0], np.int32), tv,
            rng.integers(0, V, (4, 99)).astype(np.int32))


def _jax_model(**kw):
    return JaxForceAPTAI(jcfg.tiny_config(**STACK), vocab_size=V, **kw)


def _head_outputs(model, p, fe, fl, seq, sl, tr, tv, labels, grads=True):
    """JAX ``train_from_encoded`` (with the head gradients), then
    ``predict_from_encoded`` and ``alignment_from_encoded``."""
    def loss(p):
        out = model.apply({"params": p}, fe, fl, seq, sl, tr, tv,
                          tower_frame_labels=labels,
                          method="train_from_encoded")
        return out["loss"], out

    if grads:
        (_, train), g = jax.value_and_grad(loss, has_aux=True)(p)
        g = {k: v for k, v in g.items() if k != "w2v2_pr"}
    else:
        train, g = loss(p)[1], None
    pred = model.apply({"params": p}, fe, fl, seq, sl, tr,
                       method="predict_from_encoded")
    align = model.apply({"params": p}, fe, fl, seq, sl, tr,
                        method="alignment_from_encoded")
    return train, g, pred, align


@pytest.fixture(scope="module")
def jax_force():
    """A JAX tree whose head ``ForceAPTAI.init`` made and whose tower the
    port drew (``_torch_port``), with noise on every head leaf, and every
    JAX reference output, in two compiled programs (the full path; the
    head) around the host beam search."""
    batch = _audio_batch()
    audio, lens, tv = batch["audio"], batch["audio_lengths"], \
        batch["tv_targets"]
    model = _jax_model()
    fhl = _jax_model(frame_hidden_layer=1)
    case = _encoded_case()
    init = functools.partial(model.init, method="train_from_encoded")
    rng = np.random.default_rng(22)
    noise = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.eval_shape(init, jax.random.PRNGKey(0), *case[:6])["params"])
    # a tower whose greedy decode gives item 0 more than 60 tokens
    tower = random_jax_w2v2_pr_params(tcfg.tiny_config(**STACK), seed=21)

    def full(key, noise):
        head = init(key, *case[:6])["params"]
        p = dict(jax.tree.map(jnp.add, head, noise), w2v2_pr=tower)
        return p, {
            "predict": model.apply({"params": p}, audio, lens,
                                   method="predict"),
            "alignment": model.apply({"params": p}, audio, lens,
                                     method="get_alignment"),
            "forward": model.apply({"params": p}, audio, lens, tv),
            "encode": model.apply({"params": p}, audio, lens,
                                  method="encode_frozen"),
            "encode_fhl": fhl.apply({"params": p}, audio, lens,
                                    method="encode_frozen"),
        }

    params, out = jax.device_get(jax.jit(full)(jax.random.PRNGKey(0),
                                               noise))
    enc = out["encode"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_load", lambda: None)
        beam = jbeam.beam_decode_padded(enc["ctc_log_probs"],
                                        enc["frame_lengths"], 60)
    split_in = (enc["frame_embs"], enc["frame_lengths"]) + tuple(beam)

    def heads(p):
        res = {name: _head_outputs(_jax_model(**kw), p, *case)
               for name, kw in KNOBS.items()}
        res["beam_split"] = _head_outputs(model, p, *split_in, tv, None,
                                          grads=False)
        return res

    out.update(jax.device_get(jax.jit(heads)(params)))
    return params, batch, beam, out


def _port(params, **kw) -> ForceAPTAI:
    """The port's ForceAPTAI holding the JAX tree (strict load), in eval
    mode on the CPU."""
    model = ForceAPTAI(tcfg.tiny_config(**STACK), vocab_size=V, **kw)
    model.load_state_dict(force_aptai_state_dict_from_jax(params),
                          strict=True)
    return model.eval()


def _close(got, want, what):
    """Continuous outputs within 1e-4 of the reference's largest
    magnitude (float32, different summation orders)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _check_outputs(got, want):
    """Every key of ``want`` that ``got`` has: losses to 1e-5 relative,
    integers equal, the rest by :func:`_close`; the alignment on its valid
    phoneme columns (pad columns sit near −2000, where 1e-4 of the
    magnitude would hide the valid ones)."""
    checked = 0
    for k, w in want.items():
        if k not in got or w is None:
            continue
        g = got[k]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        if k in LOSSES:
            assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-7), k
        elif k in INTS:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
        elif k == "alignment":
            w = np.asarray(w)
            lens = np.asarray(want["phn_seq_lengths"])
            for b in range(len(w)):
                _close(g[b, :, :lens[b]], w[b, :, :lens[b]], k)
                if lens[b]:  # with no token, the pads share the mass
                    assert (g[b, :, lens[b]:] < -900).all()
        else:
            _close(g, w, k)
        checked += 1
    return checked


def test_force_tree_from_jax_init_loads_strictly(jax_force):
    """The tree ``ForceAPTAI.init`` made crosses with every name mapped
    (strict load) and every head tensor in place: Dense kernels
    transposed, LSTM tensors as they are, the embedding table whole."""
    params = jax_force[0]
    model = _port(params)
    sd = model.state_dict()
    rnn = params["rnn"]
    np.testing.assert_array_equal(sd["rnn.lstm.weight_hh_l0_reverse"],
                                  rnn["w_hh_bwd"])
    np.testing.assert_array_equal(sd["rnn.lstm.bias_ih_l0"], rnn["b_ih_fwd"])
    np.testing.assert_array_equal(sd["xatt.q.weight"],
                                  params["xatt"]["q"]["kernel"].T)
    np.testing.assert_array_equal(sd["phn_encoder.embed.weight"],
                                  params["phn_encoder"]["embed"]["embedding"])
    assert np.abs(sd["phn_encoder.embed.weight"][0].numpy()).min() > 0
    np.testing.assert_array_equal(sd["w2v2_pr.pr_head.weight"],
                                  params["w2v2_pr"]["pr_head"]["kernel"].T)
    assert not any(p.requires_grad for p in model.w2v2_pr.parameters())


def test_full_path_greedy_matches_jax(jax_force):
    """``predict``, ``get_alignment`` and ``forward`` (loss, tv_loss,
    align_loss) from audio, greedy: the decoded sequences, their lengths
    and truncations, and the frame phonemes equal."""
    params, batch, _, want = jax_force
    model = _port(params)
    args = [torch.from_numpy(batch[k]) for k in ("audio", "audio_lengths")]
    with torch.no_grad():
        assert _check_outputs(model.predict(*args), want["predict"]) == 8
        assert _check_outputs(model.get_alignment(*args),
                              want["alignment"]) == 4
        got = model(*args, torch.from_numpy(batch["tv_targets"]))
    assert _check_outputs(got, want["forward"]) == 10
    lens = want["predict"]["phn_seq_lengths"]
    assert lens.min() > 0 and want["predict"]["phn_seq_truncated"].max() > 0


def test_frame_hidden_layer_matches_jax(jax_force):
    """``frame_hidden_layer=1``: the frame path takes layer 1's hidden
    state and the decode still the final logits, so ``predict`` decodes
    what the default model decodes."""
    params, batch, _, want = jax_force
    model = _port(params, frame_hidden_layer=1)
    args = [torch.from_numpy(batch[k]) for k in ("audio", "audio_lengths")]
    with torch.no_grad():
        enc = model.encode_frozen(*args)
        pred = model.predict(*args)
    assert _check_outputs(enc, want["encode_fhl"]) == 4
    assert not np.allclose(want["encode_fhl"]["frame_embs"],
                           want["encode"]["frame_embs"])
    np.testing.assert_array_equal(pred["pred_ctc_phn_seq"],
                                  want["predict"]["pred_ctc_phn_seq"])


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_from_encoded_knobs_match_jax(jax_force, knobs):
    """The head over numpy inputs (the cap hit, an infeasible item, an
    empty sequence) for each knob setting: ``train_from_encoded`` (its
    losses, outputs and head gradients), ``predict_from_encoded`` and
    ``alignment_from_encoded``."""
    params, _, _, want = jax_force
    train_w, grads_w, pred_w, align_w = want[knobs]
    model = _port(params, **KNOBS[knobs])
    fe, fl, seq, sl, tr, tv, labels = (torch.from_numpy(a)
                                       for a in _encoded_case())
    out = model.train_from_encoded(fe, fl, seq, sl, tr, tv,
                                   tower_frame_labels=labels)
    out["loss"].backward()
    assert _check_outputs(out, train_w) == 10
    if KNOBS[knobs].get("aux_frame_ce_weight"):
        assert float(train_w["aux_ce"]) > 0
    got = force_aptai_grads(model)
    want_g = {k: v for k, v in force_aptai_state_dict_from_jax(
        dict(grads_w, w2v2_pr=params["w2v2_pr"])).items()
        if not k.startswith("w2v2_pr.")}
    assert set(got) == set(want_g)
    flat_g = np.concatenate([got[k].ravel() for k in sorted(got)])
    flat_w = np.concatenate([want_g[k].numpy().ravel()
                             for k in sorted(got)])
    rel = np.linalg.norm(flat_g - flat_w) / np.linalg.norm(flat_w)
    assert rel <= 1e-4, rel
    with torch.no_grad():
        assert _check_outputs(model.predict_from_encoded(
            fe, fl, seq, sl, tr), pred_w) == 8
        assert _check_outputs(model.alignment_from_encoded(
            fe, fl, seq, sl, tr), align_w) == 4


def force_aptai_grads(model):
    """{name: gradient} of the head, as numpy; the tower has none."""
    assert all(p.grad is None for p in model.w2v2_pr.parameters())
    return {n: p.grad.numpy() for n, p in model.named_parameters()
            if not n.startswith("w2v2_pr.")}


def test_beam_host_split_path_matches_jax(jax_force):
    """``beam_host``: encode → the host beam → the head gives JAX's split
    path (sequences equal); the full forward refuses it without
    ``allow_host_callback_decode`` and with it equals the split path, as
    ``BeamDecodedBatches`` through the adapter does."""
    params, batch, beam, want = jax_force
    model = _port(params, decode_method="beam_host")
    args = [torch.from_numpy(batch[k]) for k in ("audio", "audio_lengths")]
    tv = torch.from_numpy(batch["tv_targets"])
    with torch.no_grad():
        enc = model.encode_frozen(*args)
        decoded = model.decode(enc)
        for g, w in zip(decoded, beam):
            np.testing.assert_array_equal(g.numpy(), w)
        split = (enc["frame_embs"], enc["frame_lengths"]) + tuple(decoded)
        train_w, _, pred_w, align_w = want["beam_split"]
        train = model.train_from_encoded(*split, tv)
        assert _check_outputs(train, train_w) == 10
        assert _check_outputs(model.predict_from_encoded(*split),
                              pred_w) == 8
        assert _check_outputs(model.alignment_from_encoded(*split),
                              align_w) == 4
        with pytest.raises(ValueError, match="allow_host_callback_decode"):
            model(*args, tv)
        model.allow_host_callback_decode = True
        full = model(*args, tv)
    assert full["loss"].item() == train["loss"].item()
    # the batch adapter of a beam_host trainer without the cache: the same
    # decode, the encoded layout, the same loss through the adapter
    enc_batch = next(iter(ttrain.BeamDecodedBatches([batch], model)))
    assert "audio" not in enc_batch
    np.testing.assert_array_equal(enc_batch["phn_pred_seq"].numpy(), beam[0])
    adapter = force_loss_fn(from_encoded=True)
    loss, _ = adapter(model, {k: torch.as_tensor(enc_batch[k]) for k in
                              adapter.batch_keys + adapter.optional_keys},
                      None)
    assert loss.item() == pytest.approx(train["loss"].item(), rel=1e-6)


def _wavs():
    rng = np.random.default_rng(23)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 11_000, 7_000)]


def test_predictor_behind_micro_batcher_matches_jax(jax_force):
    """``predict_batch`` with ``fields`` behind the ``MicroBatcher`` (3
    requests padded to 4 rows), ``get_faptai_output`` and
    ``get_alignment`` against the JAX ``ForceAPTAIPredictor``, greedy."""
    params = jax_force[0]
    wavs = _wavs()
    fields = ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
              "phn_seq_lengths")
    pred = ForceAPTAIPredictor(_port(params), device="cpu")
    mb = MicroBatcher(pred.predict_batch, max_batch_size=4, fields=fields)
    got = mb.run_batch(wavs)
    jpred = JaxForcePredictor(_jax_model(), params)
    for g, w in zip(got, wavs):
        # all fields on the JAX side: the same program as get_faptai_output
        want = {k: np.asarray(v)[0]
                for k, v in jpred.predict_batch([w]).items()}
        assert set(g) == set(fields) | {"frame_lengths"}
        n = int(want["frame_lengths"])
        s = int(want["phn_seq_lengths"])
        assert int(g["frame_lengths"]) == n and s > 0
        _close(g["tvs_pred"], want["tvs_pred"][:n], "tvs_pred")
        np.testing.assert_array_equal(g["pred_frame_phns"],
                                      want["pred_frame_phns"][:n])
        # the batcher cuts frame-axis arrays to the frames; the sequence
        # is read by its length
        np.testing.assert_array_equal(g["pred_ctc_phn_seq"][:s],
                                      want["pred_ctc_phn_seq"][:s])
    got_one = pred.get_faptai_output(wavs[1])
    want_one = jpred.get_faptai_output(wavs[1])
    assert got_one["pred_ctc_phn_seq"] == want_one["pred_ctc_phn_seq"]
    assert got_one["pred_frame_phns"] == want_one["pred_frame_phns"]
    for k in ("hidden_alignment", "hidden_tvs"):
        _close(got_one[k], want_one[k], k)
    for tv_name, v in want_one["tvs_pred"].items():
        _close(got_one["tvs_pred"][tv_name], v, tv_name)
    got_al = pred.get_alignment(wavs[1])["alignment"]
    want_al = jpred.get_alignment(wavs[1])["alignment"]
    _close(got_al, want_al, "alignment")


def test_beam_predictor_decodes_only_real_rows(jax_force):
    """The ``beam_host`` predictor behind the ``MicroBatcher``: the C++
    beam runs once per real row (3 of 4), the pad row gets a zero-length
    sequence, and the outputs are the model's split path on each item."""
    params = jax_force[0]
    wavs = _wavs()
    model = _port(params, decode_method="beam_host")
    pred = ForceAPTAIPredictor(model, device="cpu")
    mb = MicroBatcher(pred.predict_batch, max_batch_size=4)
    calls = tnative.beam_search_native.calls
    raw = pred.predict_batch(wavs + [np.zeros_like(wavs[0])], real_rows=3)
    assert int(raw["phn_seq_lengths"][3]) == 0
    got = mb.run_batch(wavs)
    if tnative.native_available():
        assert tnative.beam_search_native.calls == calls + 6
    for g, w in zip(got, wavs):
        # the served width: the FIR reaches into the pad frames
        a = torch.zeros((1, 16_000))
        a[0, :len(w)] = torch.from_numpy(w)
        with torch.no_grad():
            enc = model.encode_frozen(a, torch.tensor([len(w)]))
            want = model.predict_from_encoded(
                enc["frame_embs"], enc["frame_lengths"], *model.decode(enc))
        s = int(want["phn_seq_lengths"][0])
        assert int(g["phn_seq_lengths"]) == s > 0
        np.testing.assert_array_equal(g["pred_ctc_phn_seq"][:s],
                                      want["pred_ctc_phn_seq"][0, :s])
        _close(g["tvs_pred"], want["tvs_pred"][0, :len(g["tvs_pred"])],
               "tvs_pred")


def test_train_step_from_audio_and_from_cache():
    """One ``TrainStep`` (Adam, lr 1e-3) with ``force_loss_fn()`` and one
    with ``force_loss_fn(from_encoded=True)`` over ``collate_encoded(
    encode_items(...))``, dropout off: equal losses, the tower
    bit-identical, Adam state for the head tensors only, every head tensor
    moved. With dropout on, the step's masks come from its generator."""
    # items 2 and 3 (27 and 81 frames) at 81 frames' width
    batch = {k: v[2:] for k, v in _audio_batch().items()}
    batch["audio"] = batch["audio"][:, :26_000]
    batch["tv_targets"] = batch["tv_targets"][:, :81]
    base = random_force_aptai(tcfg.tiny_config(**STACK), seed=5,
                              vocab_size=V, hidden_drop=0.0, rnn_drop=0.0)
    tower = {n: p.detach().clone() for n, p in base.w2v2_pr.named_parameters()}
    head = {n for n, p in base.named_parameters()
            if not n.startswith("w2v2_pr.")}
    losses = {}
    for layout in ("audio", "cache"):
        model = copy.deepcopy(base)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        if layout == "cache":
            data = collate_encoded(encode_items([batch], model))
            assert data["frame_embs"].shape[1] == 128  # FRAME_BUCKET
            loss_fn = force_loss_fn(from_encoded=True)
        else:
            data, loss_fn = batch, force_loss_fn()
        opt = torch_adam(model)
        step = TrainStep(model, opt, loss_fn, device="cpu")
        out = step(data, 1e-3)
        losses[layout] = out["loss"].item()
        assert set(out) == {"loss", "tv_loss", "align_loss"}
        assert not model.w2v2_pr.training and model.xatt.training
        assert all(torch.equal(p, tower[n])
                   for n, p in model.w2v2_pr.named_parameters())
        names = {id(p): n for n, p in model.named_parameters()}
        assert {names[id(p)] for p in opt.state} == head
        assert all(not torch.equal(p, before[n])
                   for n, p in model.named_parameters() if n in head)
    assert losses["cache"] == pytest.approx(losses["audio"], rel=1e-5)

    model = random_force_aptai(tcfg.tiny_config(**STACK), seed=5,
                               vocab_size=V).train()
    data = collate_encoded(encode_items([batch], model))
    data = {k: torch.as_tensor(data[k])
            for k in force_loss_fn(True).batch_keys}
    drawn = [force_loss_fn(True)(model, data,
                                 torch.Generator().manual_seed(s))[0].item()
             for s in (1, 1, 2)]
    assert drawn[0] == drawn[1] != drawn[2]


def test_eval_forwards_validate_tv_and_ctc_seq_per_match_jax(jax_force):
    """``validate_tv`` and ``ctc_seq_per`` over FORCE's eval forward
    against the JAX ones fed the JAX model's outputs on the same batch;
    the encoded eval forward on the cached batch gives the same sequences
    and TVs on the valid frames."""
    params, batch, _, want = jax_force
    model = _port(params)
    fwd = ttrain.make_eval_forward(model)
    direct = fwd(batch)
    assert set(direct) == set(jtrain._EVAL_KEYS) and model.training is False
    tfwd = lambda b: direct
    jfwd = lambda b: {k: want["forward"][k] for k in jtrain._EVAL_KEYS}
    got_tv = teval.validate_tv(tfwd, [batch])
    want_tv = jeval.validate_tv(jfwd, [batch])
    assert list(got_tv) == list(want_tv)
    for k in want_tv:
        assert got_tv[k] == pytest.approx(want_tv[k], rel=1e-4, abs=1e-6), k
    logs = []
    per = ttrain.ctc_seq_per(tfwd, [batch], log_fn=logs.append)
    assert per == jtrain.ctc_seq_per(jfwd, [batch]) and per > 0
    assert logs and "60-token" in logs[0]  # item 0 hit the cap

    cached = collate_encoded(encode_items([batch], model))
    enc_out = ttrain.make_encoded_eval_forward(model)(cached)
    np.testing.assert_array_equal(enc_out["pred_ctc_phn_seq"],
                                  direct["pred_ctc_phn_seq"])
    # the FIR reaches 25 frames into the padding, which the two layouts
    # fill to other widths (99 and 128 frames)
    _close(enc_out["tvs_pred"][:, :99 - 25], direct["tvs_pred"][:, :99 - 25],
           "tvs_pred")
