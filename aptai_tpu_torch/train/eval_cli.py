"""``aptai-torch-eval``: the reference's test metrics of any trainer
checkpoint, without a training run (the JAX package's
``train/eval_cli.py``, same arguments, output and exit codes).

    python -m aptai_tpu_torch.train.eval_cli CHECKPOINT MANIFEST
        [--rate N,F] [--speaker SPK] [--split test]
        [--decode beam|greedy|beam_device] [--csv metrics.csv] [--cpu]

The checkpoint (``params.msgpack`` of either package, or an older run's
``params.pt``, with ``model_cfg.json``) names its model kind:

  * ``w2v2_pr``      → corpus PER and mean CTC loss, per manifest split
                       (CommonPhone format) or per rate (HPRC format);
  * ``aptai``        → the per-rate test dict: per-TV RMSE/PCC, FER,
                       FC-PER, overlap, boundary P/R/F1/R-value;
  * ``force_aptai``  → the APTAI dict and the decoded sequence's PER.

Output: one JSON object on stdout; ``--csv`` also writes the flattened
dict in the trainers' ``test_metrics/*.csv`` format. It runs on the card
unless ``--cpu`` is given. Exit code 2 on a filter or rate that leaves
nothing to score.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

from aptai_tpu_torch.data import (BucketedLoader, CommonPhoneDataset,
                                  HPRCDataset, collate_ctc, collate_tv)
from aptai_tpu_torch.data.manifest import read_rows, select
from aptai_tpu_torch.infer.api import resolve_device
from aptai_tpu_torch.infer.loader import load_model
from aptai_tpu_torch.train import train_aptai, train_force_aptai, train_pr
from aptai_tpu_torch.train.evaluate import test_tv, validate_pr
from aptai_tpu_torch.train.metrics import dict_to_csv


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aptai-torch-eval",
        description="Score an aptai_tpu_torch or aptai_tpu checkpoint on a "
                    "manifest (PER for recognizers; the 15-metric TV test "
                    "dict for APTAI/FORCE).")
    ap.add_argument("checkpoint", help="experiment dir or checkpoint subdir")
    ap.add_argument("manifest", help="CommonPhone- or HPRC-format csv")
    ap.add_argument("--rate", default="N,F",
                    help="comma list of HPRC rates to score separately "
                         "(HPRC manifests only; default N,F)")
    ap.add_argument("--speaker", default=None,
                    help="restrict to one speaker (HPRC manifests)")
    ap.add_argument("--split", default=None,
                    help="restrict to one value of the manifest's 'split' "
                         "column (e.g. test); default: every row")
    ap.add_argument("--decode", default="beam",
                    choices=("beam", "greedy", "beam_device"),
                    help="PR decode for PER (beam = the reference's "
                         "reported-PER protocol)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_batches", type=int, default=None,
                    help="cap batches per loader (smoke runs)")
    ap.add_argument("--csv", default=None,
                    help="also write the flattened metrics as csv")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype override (e.g. float32 to score a "
                         "bf16-trained checkpoint on CPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap


def _header(path):
    with open(path, encoding="utf-8", newline="") as f:
        return next(csv.reader(f), [])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    kind, model, vocab = load_model(args.checkpoint, dtype=args.dtype)
    model.to(device)

    columns = _header(args.manifest)
    rows = read_rows(args.manifest)
    if args.split is not None:
        if "split" not in columns:
            print(f"--split {args.split}: manifest has no 'split' column",
                  file=sys.stderr)
            return 2
        rows = select(rows, "split", args.split)
    if args.speaker is not None:
        if "speaker" not in columns:
            print("--speaker: manifest has no 'speaker' column",
                  file=sys.stderr)
            return 2
        rows = select(rows, "speaker", args.speaker)
    if not rows:
        print("no manifest rows left after filtering", file=sys.stderr)
        return 2

    # HPRC manifests carry per-frame targets; CommonPhone ones a
    # 'phonemes' transcript column
    is_hprc = "phoneme_labels" in columns
    rates = [r for r in args.rate.split(",") if r] if is_hprc else [None]
    bad = [r for r in rates if r not in (None, "N", "F", "both")]
    if bad or (is_hprc and not rates):
        print(f"--rate must be a comma list of N / F / both, got "
              f"{args.rate!r}", file=sys.stderr)
        return 2
    results = {"checkpoint": str(args.checkpoint), "kind": kind,
               "manifest": str(args.manifest), "utterances": len(rows)}
    n_meta_keys = len(results)

    if kind == "w2v2_pr":
        fwd = train_pr.make_eval_forward(model)
        for rate in rates:
            if rate is None:
                ds, tag = CommonPhoneDataset(rows, vocab), "cp"
            else:
                ds, tag = HPRCDataset(rows, vocab, rate=rate), f"hprc{rate}"
                if not len(ds):
                    continue
            dl = BucketedLoader(ds, batch_size=args.batch_size,
                                collate_fn=collate_ctc, shuffle=False)
            scored = validate_pr(fwd, dl, max_batches=args.max_batches,
                                 decode=args.decode)
            results[f"mean_{tag}_per"] = scored["mean_val_per"]
            results[f"mean_{tag}_loss"] = scored["mean_val_loss"]
    else:
        if not is_hprc:
            print(f"a {kind} checkpoint needs an HPRC-format manifest "
                  "(TV targets + frame phonemes)", file=sys.stderr)
            return 2
        trainer = train_aptai if kind == "aptai" else train_force_aptai
        fwd = trainer.make_eval_forward(model)
        for rate in rates:
            ds = HPRCDataset(rows, vocab, rate=rate)
            if not len(ds):
                continue
            dl = BucketedLoader(ds, batch_size=args.batch_size,
                                collate_fn=collate_tv, shuffle=False)
            results.update(test_tv(fwd, dl, rate,
                                   max_batches=args.max_batches))
            if kind == "force_aptai":
                # stdout carries exactly one JSON object
                per = train_force_aptai.ctc_seq_per(
                    fwd, dl, args.max_batches,
                    log_fn=lambda m: print(m, file=sys.stderr))
                results[f"test_{rate}_ctc_seq_per"] = per

    if len(results) == n_meta_keys:  # nothing was scored
        print(f"no utterances matched the requested rate(s) {rates} — no "
              "metrics produced", file=sys.stderr)
        return 2

    print(json.dumps(results, indent=2))
    if args.csv:
        dict_to_csv({k: v for k, v in results.items()
                     if isinstance(v, (int, float))}, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
