"""Long-audio streaming inference: chunked encoding with overlap stitching
(the JAX package's ``infer/streaming.py``).

  * arbitrarily long audio is cut into fixed ``chunk_seconds`` windows
    with ``overlap_seconds`` of context shared by neighbours, so every
    forward has one of a few shapes;
  * ``chunk_batch`` consecutive chunks run as one batch: each group
    uploads ONE contiguous window of ``(g - 1) · hop + chunk`` samples and
    the device cuts it into the ``(g, chunk)`` stack (``unfold``), so the
    overlaps are not uploaded twice;
  * the frame outputs are stitched at chunk centres (half the overlap is
    dropped on each inner side), on the 20 ms frame grid: ``hop`` is a
    multiple of the conv stack's total stride, so chunk-local frame t is
    absolute frame ``t + start / frame_hop``.

:class:`StreamingAPTAI` stitches APTAI's TVs and frame phonemes,
:class:`StreamingForceAPTAI` FORCE-APTAI's (the 60-phoneme cap applies per
chunk), :class:`StreamingW2V2PR` the recognizer's CTC logits.

On the card every group is enqueued before any result is read: each
group's kept outputs are copied into pinned host buffers without blocking,
and the host waits once, on an event recorded after the last copy.
``upload_ahead`` enqueues every window's upload on a side stream first;
each forward waits on its window's event.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from aptai_tpu_torch import FRAME_RATE_HZ, SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.infer.api import (TRANSFER_DTYPES, MeshRows,
                                       dequantize_transfer,
                                       quantize_transfer, resolve_device,
                                       serving_copy)


def model_cfg_strides(model) -> Tuple[int, ...]:
    """The conv stack's strides of a model of any of the three families
    (each keeps its backbone config in ``cfg``)."""
    return tuple(model.cfg.conv_stride)


def _host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` enqueued without blocking (pinned memory) when
    ``t`` is on the card; ``t`` itself on the CPU."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class StreamingPredictor:
    """Chunked streaming over a model method (``predict`` by default) whose
    outputs include the per-frame arrays named in ``frame_keys``."""

    frame_keys: Tuple[str, ...] = ("tvs_pred",)
    apply_method: str = "predict"

    def __init__(self, model, chunk_seconds: float = 20.0,
                 overlap_seconds: float = 2.0, mesh=None,
                 chunk_batch: int = 1,
                 frame_keys: Sequence[str] | None = None,
                 fetch_workers: int = 2,
                 transfer_dtype: str = "float32",
                 upload_ahead: bool = False,
                 fetch_mode: str = "pipelined",
                 device: Union[str, torch.device, None] = None):
        """``model``: a model of this package with its weights loaded,
        served as the predictors serve it (a copy on ``device``, ``cuda``
        unless named; a predictor's serving model is shared, not copied).

        ``transfer_dtype``: "float32", "int16" (lossless for 16-bit PCM,
        half the upload) or "uint8_mulaw" (lossy, a quarter).
        ``fetch_mode``: "pipelined" copies each group's outputs to the host
        as it finishes; "per_file" concatenates every group's outputs on
        the device and copies each key once. The outputs are identical.
        ``fetch_workers`` is accepted for the JAX package's API: the copies
        here are asynchronous, so no thread pool waits on them.
        ``mesh`` (``parallel.make_mesh``): every process streams the same
        recording; each group's chunk batch splits over the data axis
        (``chunk_batch`` a multiple of its size) and the model is placed on
        the model axis, and the outputs are gathered, so every process
        returns the single device's result. ``upload_ahead`` applies only
        without a mesh and raises with one, as in the JAX package."""
        if overlap_seconds >= chunk_seconds:
            raise ValueError("overlap must be smaller than the chunk")
        if getattr(model, "decode_method", "greedy") == "beam_host":
            raise ValueError(
                "streaming requires an on-device in-step decode: build the "
                "model with decode_method='greedy' (the default) or "
                "'beam_device', or use ForceAPTAIPredictor, whose split "
                "beam path runs the host beam search between the tower and "
                "the head")
        if upload_ahead and mesh is not None:
            raise ValueError(
                "upload_ahead only applies to the single-device window "
                "path; the mesh path splits each window's chunk stack over "
                "the data axis — drop upload_ahead or the mesh")
        if fetch_mode not in ("pipelined", "per_file"):
            raise ValueError(f"unknown fetch_mode {fetch_mode!r}")
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                             f"expected one of {list(TRANSFER_DTYPES)}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rows = MeshRows(mesh, self.device)
        self.model = serving_copy(model, self.device, mesh)
        if frame_keys is not None:
            self.frame_keys = tuple(frame_keys)
        self.fetch_workers = max(int(fetch_workers), 1)
        self.transfer_dtype = transfer_dtype
        self.upload_ahead = bool(upload_ahead)
        self.fetch_mode = fetch_mode
        self.chunk_batch = max(int(chunk_batch), 1)
        if self.chunk_batch % self.rows.n:
            raise ValueError(f"chunk_batch {self.chunk_batch} does not "
                             f"divide over the {self.rows.n} processes of "
                             "the data axis")
        self.chunk = int(chunk_seconds * SAMPLE_RATE)
        self.overlap = int(overlap_seconds * SAMPLE_RATE)
        self.frame_hop = int(np.prod(model_cfg_strides(model)))
        # hop must be a frame-hop multiple for exact frame tiling
        self.hop = ((self.chunk - self.overlap) // self.frame_hop
                    ) * self.frame_hop
        self.window = (self.chunk_batch - 1) * self.hop + self.chunk

    def _forward(self, audio: torch.Tensor, lengths: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """The model's outputs for a (g, chunk) stack, the kept keys only."""
        out = getattr(self.model, self.apply_method)(audio, lengths)
        return {k: out[k] for k in self.frame_keys}

    def _run(self, stack: torch.Tensor, lengths: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """:meth:`_forward` on this process's rows of the stack, gathered
        over the data axis."""
        return self.rows.gather(self._forward(self.rows.local(stack),
                                              self.rows.local(lengths)))

    def _forward_window(self, win: torch.Tensor, lengths: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """One group: the uploaded window decoded, cut into its (g, chunk)
        stack at the static offsets ``i · hop``, and run."""
        win = dequantize_transfer(win)
        stack = win.unfold(0, self.chunk, self.hop).contiguous()
        return self._run(stack, lengths)

    def _frames_for(self, n_samples: int) -> int:
        return int(self.model.cfg.feat_extract_output_lengths(
            int(n_samples)))

    def _format(self, stitched: Dict[str, np.ndarray]) -> Dict:
        """Post-process the stitched frame arrays into the output dict."""
        out = dict(stitched)
        out["frame_rate_hz"] = FRAME_RATE_HZ
        return out

    def _upload_windows(self, flat: np.ndarray, n_groups: int):
        """Each group's window and the event its forward waits on: under
        ``upload_ahead`` on the card, the window already enqueued on the
        side stream; otherwise the host window (pinned on the card's
        host), which the forward uploads in order, and None."""
        g, hop = self.chunk_batch, self.hop
        host = [torch.from_numpy(flat[i * g * hop: i * g * hop
                                      + self.window])
                for i in range(n_groups)]
        if self.device.type != "cuda":
            return [(w, None) for w in host]
        host = [w.pin_memory() for w in host]
        if not self.upload_ahead:
            return [(w, None) for w in host]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        out = []
        with torch.cuda.stream(side):
            for w in host:
                dev = w.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
                out.append((dev, ev))
        return out

    @torch.inference_mode()
    def predict(self, wav: np.ndarray) -> Dict:
        """Stream one long waveform; returns stitched per-frame outputs
        (the keys of the model's method, for any duration)."""
        wav = np.asarray(wav, np.float32)
        if len(wav) <= self.chunk:
            starts = [0]
        else:
            starts = list(range(0, len(wav) - self.overlap, self.hop))
        n_chunks = len(starts)
        lens = np.asarray(
            [min(self.chunk, len(wav) - s) for s in starts], np.int32)
        g = self.chunk_batch
        n_groups = (n_chunks + g - 1) // g
        group_sizes = [min(g, n_chunks - i * g) for i in range(n_groups)]

        # the window path: the trailing slots of a partial last group cut
        # zero padding (at full length) and their outputs are dropped
        total = (n_groups - 1) * g * self.hop + self.window
        flat = np.zeros(total, np.float32)
        flat[: len(wav)] = wav[:total]
        flat = quantize_transfer(flat, self.transfer_dtype)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        device_outs = []
        for i, (win, ready) in enumerate(self._upload_windows(flat,
                                                              n_groups)):
            if ready is not None:
                stream.wait_event(ready)
                win.record_stream(stream)  # alive until its group has run
            else:
                win = win.to(self.device, non_blocking=True)
            lens_g = np.full((g,), self.chunk, np.int32)
            lens_g[:group_sizes[i]] = lens[i * g: i * g + group_sizes[i]]
            device_outs.append(self._forward_window(
                win, torch.from_numpy(lens_g).to(self.device,
                                                 non_blocking=True)))

        if self.fetch_mode == "per_file" and n_groups > 1:
            whole = {k: _host_async(torch.cat([o[k] for o in device_outs]))
                     for k in self.frame_keys}
            fetched = [{k: v[i * g:(i + 1) * g] for k, v in whole.items()}
                       for i in range(n_groups)]
        else:
            fetched = [{k: _host_async(v) for k, v in o.items()}
                       for o in device_outs]
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
            done.synchronize()

        outs = []
        for size, out in zip(group_sizes, fetched):
            host = {k: _numpy(v) for k, v in out.items()}
            for j in range(size):
                outs.append({k: host[k][j] for k in self.frame_keys})

        parts: Dict[str, List[np.ndarray]] = {k: [] for k in self.frame_keys}
        half_ov_frames = self._frames_for(self.overlap) // 2
        prev_end_abs = 0
        for i, (s, out) in enumerate(zip(starts, outs)):
            t = self._frames_for(int(lens[i]))
            offset = s // self.frame_hop
            lo = max(prev_end_abs - offset, 0)
            hi = t if i == n_chunks - 1 else t - half_ov_frames
            prev_end_abs = offset + hi
            for k in self.frame_keys:
                parts[k].append(out[k][:t][lo:hi])

        return self._format(
            {k: np.concatenate(v, axis=0) for k, v in parts.items()})


class StreamingAPTAI(StreamingPredictor):
    """Streaming APTAI: stitched TV trajectories and frame phonemes. The
    per-frame probability matrix is opt-in (``frame_keys=("tvs_pred",
    "phn_fc_pred", "phn_fc_probs")``): at (T, vocab) float32 it outweighs
    everything else together."""

    frame_keys = ("tvs_pred", "phn_fc_pred")

    def _forward(self, audio, lengths):
        out = self.model.predict(audio, lengths, fields=self.frame_keys)
        return {k: out[k] for k in self.frame_keys}

    def _format(self, stitched):
        tvs_all = stitched["tvs_pred"]
        out = {
            "tvs_pred": {k: tvs_all[:, i] for i, k in enumerate(TV_ORDER)},
            "phn_fc_pred": stitched["phn_fc_pred"],
            "frame_rate_hz": FRAME_RATE_HZ,
        }
        if "phn_fc_probs" in stitched:
            out["phn_fc_probs"] = stitched["phn_fc_probs"]
        return out


class StreamingForceAPTAI(StreamingPredictor):
    """Streaming FORCE-APTAI: stitched TV trajectories and frame phonemes
    from the chunk-local forced alignment (greedy or ``beam_device``; the
    60-phoneme cap applies per chunk).

    The published FORCE regime is 1–2.5 s utterances with ≤ 60-token
    sequences; on long recordings the model degrades far outside it,
    streamed or whole, so treat long alignments as unreliable unless the
    head was trained on comparable durations. The TVs and the recognizer
    path do not share this caveat."""

    frame_keys = ("tvs_pred", "pred_frame_phns")

    def _format(self, stitched):
        tvs_all = stitched["tvs_pred"]
        return {
            "tvs_pred": {k: tvs_all[:, i] for i, k in enumerate(TV_ORDER)},
            "pred_frame_phns": stitched["pred_frame_phns"],
            "frame_rate_hz": FRAME_RATE_HZ,
        }


class StreamingW2V2PR(StreamingPredictor):
    """Streaming phoneme recognizer: stitched CTC logits for any length;
    the (T, vocab) logits decode on the host as the bounded path's do
    (``decode.beam.decode_with_times``), with absolute times on the 20 ms
    grid."""

    frame_keys = ("phoneme_logits",)
    apply_method = "encode"

    def _format(self, stitched):
        return {
            "phoneme_logits": stitched["phoneme_logits"],
            "frame_rate_hz": FRAME_RATE_HZ,
        }
