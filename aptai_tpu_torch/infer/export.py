"""AOT serving export: freeze a predictor forward into an on-disk bundle that
serves without the model code (the JAX package's ``infer/export.py``).

``save_serving_bundle`` exports the forward once through ``torch.export``,
at one static shape, and writes

    <dir>/forward.pt2   the exported program, weights inside
    <dir>/meta.json     static serving shape, field list, dtypes, family

``load_serving_bundle`` rebuilds a batched predictor from those two files:
no model class, no model config, no checkpoint loader. The program calls
the package's ``aptai_torch`` ops (``ops/library.py``: the kernels, and
FORCE-APTAI's packed BiLSTM and device beam), so loading imports the
modules that register them, and no other part of the package.

``platforms`` lists the devices a bundle may load on, ``cuda`` and/or
``cpu``. The program is traced on the first. A bundle that lists
``cpu`` is saved with its weights and device constants moved to the CPU
(``torch.export.passes.move_to_device_pass``), so a host without CUDA can
read it; loading moves a program to the device it serves on when it is
not there.

The program has ONE static shape (the bundle's serving shape): longer
inputs are rejected with the re-export hint, larger request lists are
chunked.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from aptai_tpu_torch import SAMPLE_RATE
from aptai_tpu_torch.infer.transfer import (dequantize_transfer,
                                           fetch_outputs, quantize_transfer,
                                           resolve_device)

# the modules that register the ``aptai_torch`` ops a program may hold
# (``ops/library.py``): all that loading a bundle imports of the package
_OP_MODULES = ("aptai_tpu_torch.ops.attention",
               "aptai_tpu_torch.ops.fused_conv", "aptai_tpu_torch.ops.lstm",
               "aptai_tpu_torch.decode.device")
_FORWARD = "forward.pt2"
_META = "meta.json"
PLATFORMS = ("cuda", "cpu")
_AUDIO_DTYPES = {"float32": torch.float32, "int16": torch.int16,
                 "uint8_mulaw": torch.uint8}


def _check_platforms(platforms: Sequence[str]) -> list:
    platforms = list(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must name one or more of {PLATFORMS}, "
                         f"got {platforms}")
    return platforms


class _ServingForward(nn.Module):
    """The exported function: wire audio → dequantised on the device →
    ``model.<method>`` → the kept fields (plus ``frame_lengths``)."""

    def __init__(self, model: nn.Module, method: str,
                 fields: Optional[Sequence[str]]):
        super().__init__()
        self.model = model
        self.method = method
        self.fields = None if fields is None else tuple(fields)

    def forward(self, audio: torch.Tensor,
                lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        from aptai_tpu_torch.infer.api import check_fields

        out = getattr(self.model, self.method)(dequantize_transfer(audio),
                                               lengths)
        if self.fields is None:
            return out
        check_fields(self.fields, out,
                     f"{type(self.model).__name__}.{self.method}")
        return {k: v for k, v in out.items()
                if k in self.fields or k == "frame_lengths"}


def _drop_dtype_asserts(program) -> None:
    """Erase the ``aten._assert_tensor_metadata`` nodes that
    ``torch.export`` writes for each traced ``.to()``: they check the
    dtypes of tensors the program makes itself at its one static shape,
    nothing uses their result, and each costs a host dispatch a batch
    (430 in a full-width APTAI program)."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if (node.op == "call_function"
                and "_assert_tensor_metadata" in str(node.target)):
            graph.erase_node(node)
    program.graph_module.recompile()


def save_serving_bundle(
    out_dir,
    model: nn.Module,
    *,
    method: str = "predict",
    batch: int = 16,
    seconds: float = 2.0,
    fields: Optional[Sequence[str]] = None,
    transfer_dtype: str = "float32",
    platforms: Sequence[str] = ("cuda",),
    kind: Optional[str] = None,
    vocab: Optional[Dict[str, int]] = None,
) -> Path:
    """Export ``model.<method>`` at the static serving shape
    ``(batch, seconds·16k)`` and write the bundle to ``out_dir``.

    The program runs the serving copy of ``model`` (``infer/api.py::
    serving_copy``: compute-dtype encoder weights, ``eval()``), traced
    under ``torch.no_grad()`` on ``platforms[0]``. ``fields`` keeps only
    those outputs (plus ``frame_lengths``); an unknown field raises.
    ``transfer_dtype="int16"`` / ``"uint8_mulaw"`` bake the device-side
    decoding of the upload in (``infer/transfer.py``)."""
    from torch.export.passes import move_to_device_pass

    from aptai_tpu_torch.infer.api import serving_copy

    if getattr(model, "decode_method", "greedy") == "beam_host":
        # the host beam search inside the forward cannot be exported (and
        # would serialise a serving host's batches anyway)
        raise ValueError(
            "cannot export a decode_method='beam_host' model: its forward "
            "embeds a host-callback beam search; export a "
            "decode_method='greedy' model (the TPU-native default)"
        )
    platforms = _check_platforms(platforms)
    if transfer_dtype not in _AUDIO_DTYPES:
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                         f"expected one of {list(_AUDIO_DTYPES)}")
    device = resolve_device(platforms[0])
    samples = int(seconds * SAMPLE_RATE)
    forward = _ServingForward(serving_copy(model, device), method,
                              fields).eval()
    audio = torch.zeros((batch, samples), dtype=_AUDIO_DTYPES[transfer_dtype],
                        device=device)
    lengths = torch.full((batch,), samples, dtype=torch.int32, device=device)
    with torch.no_grad():
        program = torch.export.export(forward, (audio, lengths),
                                      strict=False)
    _drop_dtype_asserts(program)
    if device.type != "cpu" and "cpu" in platforms:
        # torch.export.load puts each storage back on the device it was
        # saved from: a file saved from the card could not load without
        # CUDA, so a bundle that lists the CPU is saved from it
        program = move_to_device_pass(program, "cpu")

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out_dir / _FORWARD)
    (out_dir / _META).write_text(json.dumps({
        "model": type(model).__name__,
        "method": method,
        "batch": batch,
        "samples": samples,
        "fields": list(fields) if fields is not None else None,
        "transfer_dtype": transfer_dtype,
        "platforms": platforms,
        "sample_rate": SAMPLE_RATE,
        # serving identity: lets aptai-torch-serve rebuild the family's
        # response schema (and IPA mapping) from the bundle alone
        "kind": kind,
        "vocab": vocab,
    }, indent=2))
    return out_dir


class ServingBundle:
    """A loaded bundle: batched prediction from the program alone, on
    ``device`` (``cuda`` unless named), which must be one of the bundle's
    platforms."""

    def __init__(self, bundle_dir, device=None):
        from torch.export.passes import move_to_device_pass

        for module in _OP_MODULES:  # the ops exist before the program loads
            importlib.import_module(module)
        bundle_dir = Path(bundle_dir)
        self.meta = json.loads((bundle_dir / _META).read_text())
        self.device = resolve_device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"the bundle {bundle_dir} was exported for "
                f"{self.meta['platforms']}, not {self.device.type}; "
                f"re-export it with --platforms listing {self.device.type}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        program = torch.export.load(bundle_dir / _FORWARD)
        held = next(iter(program.state_dict.values())).device
        if held != self.device:
            program = move_to_device_pass(program, self.device)
        self.program = program
        self._forward = program.module()

    def predict_batch(self, wavs: Sequence[np.ndarray]) -> Dict:
        """Pad/chunk to the exported static shape, run, and return every
        output with leading dim ``len(wavs)`` (the live ``predict_batch``'s
        contract).

        A single chunk returns device tensors (sliced views) with no
        synchronisation: the MicroBatcher's fetch pool fetches them while
        its dispatch loop enqueues the next batch. Several chunks (library
        use beyond the exported batch) are concatenated on the host."""
        batch = int(self.meta["batch"])
        samples = int(self.meta["samples"])
        if not wavs:
            raise ValueError("predict_batch needs at least one waveform")
        too_long = [i for i, w in enumerate(wavs) if len(w) > samples]
        if too_long:
            raise ValueError(
                f"input(s) {too_long} exceed the exported serving shape of "
                f"{samples} samples ({samples / SAMPLE_RATE:.1f} s); "
                "re-export with a larger `seconds`"
            )
        parts = []
        for lo in range(0, len(wavs), batch):
            group = wavs[lo:lo + batch]
            audio = np.zeros((batch, samples), np.float32)
            # pad rows: full-length silence (infer/api.py:_prepare contract)
            lengths = np.full((batch,), samples, np.int32)
            for i, w in enumerate(group):
                audio[i, : len(w)] = np.asarray(w, np.float32)
                lengths[i] = len(w)
            audio = quantize_transfer(audio, self.meta["transfer_dtype"])
            with torch.inference_mode():
                out = self._forward(torch.from_numpy(audio).to(self.device),
                                    torch.from_numpy(lengths).to(self.device))
            parts.append({k: v[: len(group)] for k, v in out.items()})
        if len(parts) == 1:
            return parts[0]
        host = [fetch_outputs(p) for p in parts]
        return {k: np.concatenate([h[k] for h in host], axis=0)
                for k in host[0]}


def load_serving_bundle(bundle_dir, device=None) -> ServingBundle:
    return ServingBundle(bundle_dir, device=device)


def is_bundle(path) -> bool:
    """True when ``path`` is a serving bundle directory of this package
    (vs a trainer checkpoint)."""
    p = Path(path)
    return (p / _FORWARD).is_file() and (p / _META).is_file()


def main(argv=None) -> int:
    """``aptai-torch-export``: trainer checkpoint (of either package) →
    serving bundle.

    The deployment path: train → ``aptai-torch-export`` → serve the bundle
    (``aptai-torch-serve --checkpoint <bundle>`` or :class:`ServingBundle`
    directly), with no model code or checkpoint loader on the host."""
    import argparse

    p = argparse.ArgumentParser(
        prog="aptai-torch-export",
        description="Export a trainer checkpoint as a serving bundle "
                    "(torch.export program with its weights + metadata)")
    p.add_argument("checkpoint", help="trainer run dir / best-model-ckpt dir")
    p.add_argument("out_dir", help="bundle output directory")
    p.add_argument("--batch", type=int, default=16,
                   help="static serving batch size")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="static serving audio length cap")
    p.add_argument("--fields", default="",
                   help="comma list; default: the family's serving set")
    p.add_argument("--transfer_dtype", default="float32",
                   choices=tuple(_AUDIO_DTYPES),
                   help="wire audio encoding baked into the program")
    p.add_argument("--platforms", default="cuda",
                   help="comma list of devices the bundle may load on "
                        "(cuda, cpu); the program is traced on the first")
    p.add_argument("--dtype", default=None,
                   help="compute dtype override (e.g. bfloat16 for a card "
                        "bundle, float32 for CPU parity)")
    args = p.parse_args(argv)

    from aptai_tpu_torch.infer.loader import load_model
    from aptai_tpu_torch.infer.serve import KIND_FIELDS

    kind, model, vocab = load_model(args.checkpoint, dtype=args.dtype)
    method = "encode" if kind == "w2v2_pr" else "predict"
    fields = ([f for f in args.fields.split(",") if f]
              or list(KIND_FIELDS[kind]))
    try:
        out = save_serving_bundle(
            args.out_dir, model, method=method, batch=args.batch,
            seconds=args.seconds, fields=fields,
            transfer_dtype=args.transfer_dtype,
            platforms=tuple(s for s in args.platforms.split(",") if s),
            kind=kind, vocab=vocab,
        )
    except ValueError as e:  # e.g. beam_host models cannot be exported
        print(f"aptai-torch-export: {e}", file=sys.stderr)
        return 2
    size = sum(f.stat().st_size for f in out.iterdir())
    print(json.dumps({
        "bundle": str(out), "kind": kind, "batch": args.batch,
        "seconds": args.seconds, "fields": fields,
        "platforms": args.platforms.split(","),
        "bytes": size,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
