"""``aptai-torch-predict``: batch inference from a trainer checkpoint (the
JAX package's ``python -m aptai_tpu.infer``, same arguments and output).

    python -m aptai_tpu_torch.infer <checkpoint_dir> wav [wav ...]
        [--out DIR] [--task alignment] [--batch_size N]
        [--transfer_dtype float32|int16|uint8_mulaw] [--dtype D] [--cpu]

``checkpoint_dir`` is any trainer experiment dir (or its best/last/
per-epoch checkpoint subdir) of either package: ``model_cfg.json`` names
the model kind (``infer/loader.py``), so one CLI serves all three:

  * ``aptai``        → per-frame TV trajectories and frame phonemes;
  * ``force_aptai``  → TVs, frame phonemes and the CTC phoneme sequence
                       (``--task alignment``: the (phonemes × frames)
                       log-softmax alignment matrix instead);
  * ``w2v2_pr``      → the beam-decoded phoneme sequence and start times.

One ``<stem>.json`` per utterance under ``--out``, else JSON lines on
stdout. Wavs are resampled to 16 kHz on load. It runs on the card unless
``--cpu`` is given. Exit code 2 for ``--task alignment`` on a checkpoint
that is not FORCE-APTAI.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from aptai_tpu_torch.data.audio_io import load_wav_16k
from aptai_tpu_torch.data.vocab import ids_to_phonemes
from aptai_tpu_torch.infer.api import (TRANSFER_DTYPES, APTAIPredictor,
                                      ForceAPTAIPredictor, W2V2PRPredictor,
                                      _tv_dict, fetch_outputs)
from aptai_tpu_torch.infer.loader import load_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aptai-torch-predict",
        description="Batched inference from an aptai_tpu_torch or aptai_tpu "
                    "checkpoint.")
    ap.add_argument("checkpoint", help="experiment dir or checkpoint subdir")
    ap.add_argument("wavs", nargs="+", help="input wav files")
    ap.add_argument("--out", default=None,
                    help="output directory (one <stem>.json per wav); "
                         "default: JSON lines on stdout")
    ap.add_argument("--task", default="auto",
                    choices=("auto", "alignment"),
                    help="'alignment' (FORCE checkpoints only) writes the "
                         "(phonemes x frames) alignment matrix")
    ap.add_argument("--batch_size", type=int, default=16,
                    help="wavs per device batch (batched families)")
    ap.add_argument("--transfer_dtype", default="float32",
                    choices=TRANSFER_DTYPES,
                    help="int16 halves the host->device audio upload "
                         "(lossless for 16-bit PCM sources); uint8_mulaw "
                         "quarters it (G.711 mu-law, lossy ~38 dB SNR)")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype override (e.g. float32 to run a "
                         "bf16-trained checkpoint in float32)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    return ap


def _emit(args, stem: str, payload: dict) -> None:
    if args.out:
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{stem}.json").write_text(json.dumps(payload))
    else:
        print(json.dumps({"utterance": stem, **payload}))


def _chunks(seq, n):
    for i in range(0, len(seq), n):
        yield i, seq[i:i + n]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else None
    kind, model, vocab = load_model(args.checkpoint, dtype=args.dtype)
    if args.task == "alignment" and kind != "force_aptai":
        print(f"--task alignment needs a force_aptai checkpoint, got {kind}",
              file=sys.stderr)
        return 2

    kw = dict(device=device, transfer_dtype=args.transfer_dtype)
    if kind == "w2v2_pr":
        pred = W2V2PRPredictor(model, vocab, **kw)
    elif kind == "aptai":
        pred = APTAIPredictor(model, **kw)
    else:
        pred = ForceAPTAIPredictor(model, **kw)

    stems = [Path(w).stem for w in args.wavs]
    wavs = [load_wav_16k(w) for w in args.wavs]

    if kind == "w2v2_pr":
        for stem, wav in zip(stems, wavs):
            out = pred.predict_phonemes_durations(wav)
            _emit(args, stem, {
                "phn_seq_idx": np.asarray(out["phn_seq_idx"]).tolist(),
                "phn_seq_ipa": out["phn_seq_ipa"],
                "phn_seq_dur": [float(d) for d in out["phn_seq_dur"]],
            })
        return 0

    if args.task == "alignment":
        for stem, wav in zip(stems, wavs):
            out = pred.get_alignment(wav)
            _emit(args, stem, {
                "alignment": np.asarray(out["alignment"]).tolist()})
        return 0

    fields = (("tvs_pred", "phn_fc_pred") if kind == "aptai" else
              ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
               "phn_seq_lengths"))
    for start, chunk in _chunks(wavs, max(args.batch_size, 1)):
        out = fetch_outputs(pred.predict_batch(chunk, fields=fields))
        for b in range(len(chunk)):
            n = int(out["frame_lengths"][b])
            payload = {"tvs_pred": _tv_dict(out["tvs_pred"][b, :n])}
            if kind == "aptai":
                frames = out["phn_fc_pred"][b, :n].tolist()
            else:
                frames = out["pred_frame_phns"][b, :n].tolist()
                s = int(out["phn_seq_lengths"][b])
                seq = out["pred_ctc_phn_seq"][b, :s].tolist()
                payload["pred_ctc_phn_seq"] = seq
                payload["pred_ctc_phn_seq_ipa"] = ids_to_phonemes(vocab, seq)
            payload["pred_frame_phns"] = frames
            payload["pred_frame_phns_ipa"] = ids_to_phonemes(vocab, frames)
            _emit(args, stems[start + b], payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
