"""The FORCE-APTAI trainer and its CLI: the leave-one-speaker-out loop over
the frozen W2V2PR tower (the JAX package's ``train/train_force_aptai.py``),
with FORCE's loss adapter, batch adapter, evaluation forwards and the
decoded-sequence PER.

The tower is frozen inside the model (``ForceAPTAI``): ``torch_adam``
gives it no state and no gradient reaches it, the counterpart of the JAX
trainer's ``optax.masked``. With ``--cache_frozen_encodings`` (the
default) the tower and the decode run once per utterance and the head
trains from the cache; when the tower comes from a W2V2PR checkpoint
(``pr_spliced``) the whole manifest is encoded once per run and shared by
the folds.

Over several processes (``--coordinator_address``, on the mesh of
``--mesh_data``, ``--mesh_model`` and ``--fsdp``) each cache pass splits
its batches over the data axis and gathers the encodings, so every process
holds the whole cache; the head steps on each process's rows of every
batch; the collapse guard's decision is agreed by every process, so all
fall back to ``beam_host`` together; every process validates and tests,
and the primary alone writes files.

Usage:
  python -m aptai_tpu_torch.train.train_force_aptai --hprc_csv_path ... \
      --pr_model_path <W2V2PR run> --vocab_path <W2V2PR run>/vocab.json
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from aptai_tpu_torch.data import PrefetchLoader
from aptai_tpu_torch.data.hprc import loso_split
from aptai_tpu_torch.data.manifest import unique
from aptai_tpu_torch.decode.native import edit_distance
from aptai_tpu_torch.infer.api import fetch_outputs
from aptai_tpu_torch.parallel.mesh import load_full_state_dict
from aptai_tpu_torch.parallel.multihost import (any_process, host_barrier,
                                                is_primary)
from aptai_tpu_torch.train.builders import build_force_model
from aptai_tpu_torch.models.convert import (
    jax_w2v2_pr_params_from_state_dict)
from aptai_tpu_torch.train.checkpoints import (FLAX_PARAMS, PARAMS,
                                               CheckpointManager,
                                               flax_params_tree, read_params,
                                               save_json, save_msgpack,
                                               to_host)
from aptai_tpu_torch.train.config import (ForceAPTAIConfig, parse_config,
                                          run_device)
from aptai_tpu_torch.train.evaluate import test_tv, validate_tv
from aptai_tpu_torch.train.frozen_cache import (FrozenEncodedCorpus,
                                                FrozenEncodedLoader,
                                                encode_batch)
from aptai_tpu_torch.train.harness import run_mesh
from aptai_tpu_torch.train.loop import fit
from aptai_tpu_torch.train.metrics import aggregate_mean_std, dict_to_csv
from aptai_tpu_torch.train.train_aptai import (_loader, eval_call,
                                               fold_peak_memory, read_hprc)
from aptai_tpu_torch.utils.logging import RunLogger

TOWER = "w2v2_pr."

AUDIO_KEYS = ("audio", "audio_lengths", "tv_targets")
ENCODED_KEYS = ("frame_embs", "enc_frame_lengths", "phn_pred_seq",
                "phn_seq_lengths", "phn_seq_truncated", "tv_targets")
EVAL_KEYS = ("loss", "tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
             "phn_seq_lengths", "phn_seq_truncated")


def force_loss_fn(from_encoded: bool = False) -> Callable:
    """The FORCE adapter: ``loss_fn(model, batch, generator) -> (loss,
    {"tv_loss", "align_loss"})``.

    * audio layout (default): ``audio`` (B, L), ``audio_lengths`` (B,) in
      samples and ``tv_targets`` (B, T, 9): the tower, the greedy decode
      and the head in one forward;
    * ``from_encoded``: the tower's outputs and decoded sequences
      (:func:`~aptai_tpu_torch.train.frozen_cache.collate_encoded` or
      :class:`BeamDecodedBatches`): the head alone. The aux frame CE reads
      ``tower_frame_labels`` when the batch has it (``optional_keys``).

    A ``beam_host`` model trains from the encoded layout; its audio
    forward refuses to run."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        if from_encoded:
            out = model.train_from_encoded(
                *(batch[k] for k in ENCODED_KEYS), generator=generator,
                tower_frame_labels=batch.get("tower_frame_labels"))
        else:
            out = model(*(batch[k] for k in AUDIO_KEYS), generator=generator)
        return out["loss"], {"tv_loss": out["tv_loss"],
                             "align_loss": out["align_loss"]}

    loss_fn.batch_keys = ENCODED_KEYS if from_encoded else AUDIO_KEYS
    loss_fn.optional_keys = ("tower_frame_labels",) if from_encoded else ()
    return loss_fn


class BeamDecodedBatches:
    """Batches of the encoded layout from audio batches, for a
    ``beam_host`` model without the cache: per batch the tower on the
    model's device, the beam search on the calling thread
    (``ForceAPTAI.decode``, real rows only), and the batch with ``audio``
    replaced by ``frame_embs``, ``enc_frame_lengths``, the decoded
    sequences and ``tower_frame_labels`` (device tensors). Over several
    processes ``fit`` splits ``loader``'s batches (``loop.split_rows``
    reaches it as ``.loader``): each process encodes its own rows."""

    def __init__(self, loader: Iterable[Dict], model):
        self.loader = loader
        self.model = model

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            mask = batch.get("batch_pad_mask")
            n = None if mask is None else int(np.asarray(mask).sum())
            enc = encode_batch(self.model, batch["audio"],
                               batch["audio_lengths"], n_real=n)
            out = {k: v for k, v in batch.items() if k != "audio"}
            out["enc_frame_lengths"] = enc.pop("frame_lengths")
            out.update(enc)
            yield out


def make_encoded_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {EVAL_KEYS}`` over batches of the encoded layout
    (the head alone), in ``eval()`` under ``torch.no_grad()``."""

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: model.train_from_encoded(
            *(torch.as_tensor(batch[k]).to(dev) for k in ENCODED_KEYS)))
        return {k: out[k] for k in EVAL_KEYS}

    return forward


def make_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {EVAL_KEYS}`` (device tensors) over audio
    batches (``audio``, ``audio_lengths``, ``tv_targets``), in ``eval()``
    under ``torch.no_grad()``: the whole forward for greedy; for
    ``beam_host`` the split path (tower, host beam, head)."""
    if model.decode_method != "beam_host":
        def forward(batch) -> Dict[str, torch.Tensor]:
            out = eval_call(model, lambda dev: model(
                *(torch.as_tensor(batch[k]).to(dev) for k in AUDIO_KEYS)))
            return {k: out[k] for k in EVAL_KEYS}

        return forward

    def split(dev, batch):
        enc = encode_batch(model, batch["audio"], batch["audio_lengths"])
        return model.train_from_encoded(
            enc["frame_embs"], enc["frame_lengths"], enc["phn_pred_seq"],
            enc["phn_seq_lengths"], enc["phn_seq_truncated"],
            torch.as_tensor(batch["tv_targets"]).to(dev))

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: split(dev, batch))
        return {k: out[k] for k in EVAL_KEYS}

    return forward


def ctc_seq_per(forward_fn: Callable, batches: Iterable[Dict],
                max_batches: Optional[int] = None,
                log_fn: Optional[Callable] = None) -> float:
    """PER of the decoded phoneme sequence (``pred_ctc_phn_seq``) against
    the batch's ``phoneme_labels`` (padded −100), Σedit / Σlen over the
    real rows; ``log_fn`` hears how many items lost phonemes to the
    60-token cap."""
    edits = lengths = truncated = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = fetch_outputs(forward_fn(batch))
        seqs, lens = out["pred_ctc_phn_seq"], out["phn_seq_lengths"]
        trunc = out.get("phn_seq_truncated", np.zeros(len(seqs), np.int32))
        mask = batch.get("batch_pad_mask", np.ones(len(seqs), bool))
        for b in range(len(seqs)):
            if not mask[b]:
                continue
            labels = np.asarray(batch["phoneme_labels"][b])
            gt = labels[labels >= 0].tolist()
            edits += edit_distance(gt, seqs[b, :int(lens[b])].tolist())
            lengths += len(gt)
            truncated += int(trunc[b] > 0)
    if truncated and log_fn is not None:
        log_fn(f"WARNING: {truncated} utterances lost phonemes to the "
               "60-token decode cap (reference force_aptai.py:111 asserts)")
    return edits / max(lengths, 1)


class _DecodeCollapse(Exception):
    """Raised by the validation guard to trigger the beam_host fallback."""


def _split_tower(params) -> tuple:
    """``(tower, head)`` entries of a ForceAPTAI state dict."""
    tower = {k: v for k, v in params.items() if k.startswith(TOWER)}
    head = {k: v for k, v in params.items() if not k.startswith(TOWER)}
    return tower, head


class _TowerMergingCkpt:
    """A CheckpointManager for a fold trained from the frozen-tower cache,
    as the JAX trainer's: the epochs' saves hold the head alone (a few MB)
    beside one ``frozen_tower.msgpack`` (``{"w2v2_pr": tower}``) written
    at the first save, instead of the ~1.3 GB constant tower each time;
    restores give the whole model's state dict, and :meth:`finalize` (the
    fold's end) rewrites best and last as whole-model ``params.msgpack``,
    the public format."""

    def __init__(self, inner: CheckpointManager, tower):
        self._inner = inner
        self._tower = tower
        self._tower_tree = None
        self._tower_file = inner.exp_dir / "frozen_tower.msgpack"

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _jax_tower(self):
        """The tower as the JAX package's W2V2PR tree, on the host."""
        if self._tower_tree is None:
            self._tower_tree = to_host(jax_w2v2_pr_params_from_state_dict(
                {k[len(TOWER):]: v for k, v in self._tower.items()}))
        return self._tower_tree

    def _head(self, params):
        """The head's entries of ``params``, the tower file written first
        if it is not there yet."""
        if not self._tower_file.exists():
            save_msgpack(self._tower_file, {"w2v2_pr": self._jax_tower()})
        return _split_tower(params)[1]

    def _whole(self, params):
        return {**self._tower, **_split_tower(params)[1]}

    def update(self, epoch, metrics, params, **kw):
        return self._inner.update(epoch, metrics, self._head(params), **kw)

    def save_interrupt(self, resume_epoch, params, **kw):
        return self._inner.save_interrupt(resume_epoch, self._head(params),
                                          **kw)

    def restore_last(self, map_location=None):
        params, opt_state, meta = self._inner.restore_last(map_location)
        return self._whole(params), opt_state, meta

    def restore_best(self, map_location=None):
        return self._whole(self._inner.restore_best(map_location))

    def finalize(self):
        """Best and last ``params.msgpack`` as whole-model trees."""
        for d in (self._inner.best_dir, self._inner.last_dir):
            if not ((d / PARAMS).exists() or (d / FLAX_PARAMS).exists()):
                continue
            head = read_params(d)
            if any(k.startswith(TOWER) for k in head):
                continue  # already whole
            save_msgpack(d / FLAX_PARAMS, {**flax_params_tree(head),
                                           "w2v2_pr": self._jax_tower()})
            (d / PARAMS).unlink(missing_ok=True)


def run_speaker(cfg, rows, vocab, test_spk, model, model_cfg,
                corpus_cache: Optional[FrozenEncodedCorpus] = None,
                mesh=None):
    """One LOSO fold of ``model`` (on the run's device); returns the test
    metric dict for ``test_spk``, with ``decode_fallback`` 1 when the
    blank-collapse guard switched the fold to ``beam_host``. ``mesh``: the
    run's (``harness.run_mesh``), over which the fold's cache passes
    split."""
    device = run_device(cfg)
    primary = is_primary()
    exp_dir = Path(cfg.exp_dir)
    train, valid, test_n, test_f = loso_split(rows, test_spk,
                                              cfg.train_val_rate,
                                              seed=cfg.seed)
    eval_bs = cfg.eval_batch_size or cfg.batch_size
    cached = cfg.cache_frozen_encodings

    def train_loader(beam: bool):
        """The fold's training batches; ``beam``: for the beam_host
        fallback, which encodes anew (the shared cache holds the primary
        decode's sequences)."""
        if cached:
            if corpus_cache is not None and not beam:
                enc_dl = corpus_cache.loader_for(train, cfg.batch_size,
                                                 seed=cfg.seed)
            else:
                enc_dl = FrozenEncodedLoader(
                    _loader(train, vocab, cfg.batch_size, False), model,
                    seed=cfg.seed, mesh=mesh)
                print(f"frozen-tower cache: {len(enc_dl.dataset)} "
                      f"utterances, {enc_dl.cache_bytes / 1e6:.1f} MB host")
            return PrefetchLoader(enc_dl)
        dl = PrefetchLoader(_loader(train, vocab, cfg.batch_size, True,
                                    cfg.seed))
        return (BeamDecodedBatches(dl, model)
                if model.decode_method == "beam_host" else dl)

    def val_setup(beam: bool):
        """(eval forward, validation batches): with the cache, the tower
        runs over the validation rows once and validation is head-only."""
        if not cached:
            return (make_eval_forward(model),
                    _loader(valid, vocab, eval_bs, False))
        if corpus_cache is not None and not beam:
            val_dl = corpus_cache.loader_for(valid, eval_bs, shuffle=False)
        else:
            val_dl = FrozenEncodedLoader(_loader(valid, vocab, eval_bs,
                                                 False), model, shuffle=False,
                                         mesh=mesh)
        return make_encoded_eval_forward(model), val_dl

    max_b = 5 if cfg.laptop else None

    def make_validate(fwd, val_dl, allow_fallback, already_beam=False):
        streak = {"n": 0}

        def validate(epoch):
            logs = validate_tv(fwd, val_dl, max_batches=max_b)
            logs["val_ctc_seq_per"] = ctc_seq_per(fwd, val_dl, max_b,
                                                  log_fn=print)
            # blank-collapse guard: a collapsed recognizer makes the greedy
            # decode emit empty sequences and the alignment goes dead
            # while training runs normally
            per = logs["val_ctc_seq_per"]
            streak["n"] = streak["n"] + 1 if (
                per >= cfg.collapse_per_threshold) else 0
            collapsed = streak["n"] >= cfg.collapse_patience
            fall_back = allow_fallback and cfg.collapse_fallback
            if collapsed:
                if fall_back:
                    tail = ", falling back to decode_method=beam_host"
                elif already_beam:
                    tail = ("; beam decode is ALREADY active, so the "
                            "stage-1 PR checkpoint itself is likely "
                            "degenerate — retrain or re-point "
                            "--pr_model_path")
                else:
                    tail = (" (set --collapse_fallback to auto-switch to "
                            "beam_host)")
                print(
                    f"WARNING: in-step CTC decode collapsed — "
                    f"val_ctc_seq_per={per:.3f} >= "
                    f"{cfg.collapse_per_threshold} for {streak['n']} "
                    "consecutive epochs; the aligner is receiving "
                    "degenerate phoneme sequences.  Verify the stage-1 PR "
                    "checkpoint is converged" + tail
                )
            # every process falls back, or none: the decision is agreed
            if fall_back and any_process(collapsed):
                raise _DecodeCollapse
            return logs

        return validate

    ckpt = CheckpointManager(
        exp_dir / f"best-model-ckpt-{test_spk}", cfg.target_metric,
        bigger_is_better=cfg.target_metric_bigger_better,
    )
    tower, head = _split_tower(model.state_dict())
    if cached:
        ckpt = _TowerMergingCkpt(ckpt, tower)
    logger = (RunLogger(exp_dir, "FORCE_APTAI",
                        run_name=f"{cfg.prefix}_{test_spk}",
                        use_wandb=cfg.logging) if primary else None)
    from_encoded = cached or model.decode_method == "beam_host"
    # only the greedy decode has a beam to fall back to
    can_fall_back = model.decode_method == "greedy"
    initial_head = ({k: v.to("cpu", copy=True) for k, v in head.items()}
                    if can_fall_back and cfg.collapse_fallback else None)
    fell_back = False
    try:
        fit(cfg, force_loss_fn(from_encoded=from_encoded), model,
            train_loader(beam=False),
            make_validate(*val_setup(beam=False), can_fall_back,
                          already_beam=model.decode_method != "greedy"),
            ckpt, model_cfg=model_cfg, logger=logger,
            frozen_prefixes=(TOWER,))
    except _DecodeCollapse:
        fell_back = True
        print(f"-> resuming fold {test_spk} with decode_method=beam_host "
              "from the last checkpoint")
        # from the fold's start, or from its last checkpoint when one was
        # written before the collapse
        load_full_state_dict(model, initial_head, strict=False)
        model.decode_method = "beam_host"
        fit(dataclasses.replace(cfg, train_from_ckpt=True),
            force_loss_fn(from_encoded=True), model, train_loader(beam=True),
            make_validate(*val_setup(beam=True), False, already_beam=True),
            ckpt, model_cfg=model_cfg, logger=logger,
            frozen_prefixes=(TOWER,))

    load_full_state_dict(model, ckpt.restore_best(map_location=device))
    if cached:
        if primary:
            ckpt.finalize()
        host_barrier()
    fwd = make_eval_forward(model)
    results = {"decode_fallback": int(fell_back)}
    tmax = 1 if cfg.laptop else None
    test_dls = {rate: _loader(part, vocab, eval_bs, False)
                for rate, part in (("N", test_n), ("F", test_f))}
    for rate, dl in test_dls.items():
        results.update(test_tv(fwd, dl, rate, max_batches=tmax))
    for rate, dl in test_dls.items():
        results[f"test_{rate}_ctc_seq_per"] = ctc_seq_per(fwd, dl, tmax,
                                                          log_fn=print)
    if primary:
        metrics_dir = exp_dir / "test_metrics"
        metrics_dir.mkdir(parents=True, exist_ok=True)
        dict_to_csv(results, metrics_dir / f"{test_spk}.csv")
    return results


def run(cfg, tiny_backbone=None, speakers=None):
    """The LOSO run over ``speakers`` (every speaker of the manifest by
    default); returns ``(mean, std, per-speaker results)``. Each fold draws
    a fresh head (``seed + fold``) over the checkpoint's tower and frees
    the previous fold's model and optimizer first. Over several processes
    every process runs every fold, and the primary writes the files."""
    device = run_device(cfg)
    exp_dir = Path(cfg.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    if is_primary():
        save_json(exp_dir / "experiment_args.json", cfg)
    rows, vocab = read_hprc(cfg)
    speakers = speakers or unique(rows, "speaker")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model, model_cfg = build_force_model(cfg, vocab, cfg.pr_model_path,
                                         tiny=tiny_backbone)
    model.to(device)
    mesh = run_mesh(cfg)
    # a tower from the checkpoint is the same in every fold: encode the
    # whole manifest once and share it; a random tower differs per fold
    corpus_cache = None
    if cfg.cache_frozen_encodings and model_cfg["pr_spliced"]:
        corpus_cache = FrozenEncodedCorpus(rows, vocab, model, cfg.batch_size,
                                           mesh=mesh)
        print(f"corpus frozen-tower cache: {len(corpus_cache)} utterances, "
              f"{corpus_cache.cache_bytes / 1e6:.1f} MB host "
              "(shared across LOSO folds)")

    per_speaker = []
    for fold, test_spk in enumerate(speakers):
        print(f"=== LOSO fold: held-out speaker {test_spk} ===")
        if fold > 0:
            del model
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            model, _ = build_force_model(cfg, vocab, cfg.pr_model_path,
                                         tiny=tiny_backbone,
                                         seed=cfg.seed + fold)
            model.to(device)
        per_speaker.append(run_speaker(cfg, rows, vocab, test_spk, model,
                                       model_cfg, corpus_cache=corpus_cache,
                                       mesh=mesh))
        fold_peak_memory(device, test_spk)
    mean, std = aggregate_mean_std(per_speaker)
    if is_primary():
        dict_to_csv(mean, exp_dir / "loso_mean.csv")
        dict_to_csv(std, exp_dir / "loso_std.csv")
    return mean, std, per_speaker


def main(argv=None):
    return run(parse_config(ForceAPTAIConfig, "FORCE_APTAI", argv))


if __name__ == "__main__":
    main()
