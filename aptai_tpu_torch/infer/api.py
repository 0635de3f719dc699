"""The predictors: batched inference with the reference output schemas.

Each pads a list of waveforms to one bucketed shape (whole seconds; the
batch rounded up to a power of two, pad rows being full-width silence),
uploads it in one of three transfer encodings, decodes it on the device,
runs the model and slices the pad rows off:

* :class:`APTAIPredictor` runs ``APTAI.predict``; ``get_aptai_output``
  gives the single-utterance dict of the reference;
* :class:`W2V2PRPredictor` runs ``W2V2PR.encode``; ``get_embeddings``,
  ``get_ctc_logits``, ``predict_phonemes_durations`` and ``pred_phn_seq``
  give the reference's dicts, with the host beam search
  (``aptai_tpu_torch.decode``: the C++ beam first, the Python one without
  its library);
* :class:`ForceAPTAIPredictor` runs ``ForceAPTAI.predict`` (greedy) or its
  split ``beam_host`` path; ``get_faptai_output`` and ``get_alignment``
  give the reference's dicts.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from aptai_tpu_torch import SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.data.batching import AUDIO_BUCKET
from aptai_tpu_torch.data.vocab import ids_to_phonemes
from aptai_tpu_torch.decode.beam import decode_best, decode_with_times
from aptai_tpu_torch.models import force_aptai
from aptai_tpu_torch.models.aptai import PREDICT_FIELDS
from aptai_tpu_torch.models.w2v2_pr import ENCODE_FIELDS
from aptai_tpu_torch.models.wav2vec2 import cast_matmul_weights, compute_dtype


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA device on a machine without one raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def _bucket(n: int, bucket: int = AUDIO_BUCKET) -> int:
    return max(int(math.ceil(n / bucket)) * bucket, bucket)


def _batch_bucket(n: int) -> int:
    """Next power of two ≥ n: a small fixed set of batch shapes."""
    return 1 << max(0, (n - 1)).bit_length()


def quantize_i16(audio: np.ndarray) -> np.ndarray:
    """float waveform → int16 (half the bytes; lossless for audio decoded
    from 16-bit PCM, ``round(f · 32768)``)."""
    return np.clip(np.rint(np.asarray(audio, np.float32)
                           * np.float32(32768.0)),
                   -32768, 32767).astype(np.int16)


def quantize_mulaw(audio: np.ndarray) -> np.ndarray:
    """float waveform → 8-bit μ-law (μ=255, lossy), biased by +128 so the
    wire dtype is uint8."""
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    mu = np.float32(255.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    q = np.clip(np.rint(y * 127.0), -127, 127) + 128.0
    return q.astype(np.uint8)


_QUANTIZERS = {"int16": quantize_i16, "uint8_mulaw": quantize_mulaw}
TRANSFER_DTYPES = ("float32",) + tuple(_QUANTIZERS)


def quantize_transfer(audio: np.ndarray, transfer_dtype: str) -> np.ndarray:
    """Encode a host float waveform for upload per ``transfer_dtype``."""
    if transfer_dtype == "float32":
        return np.asarray(audio, np.float32)
    try:
        return _QUANTIZERS[transfer_dtype](audio)
    except KeyError:
        raise ValueError(
            f"unknown transfer_dtype {transfer_dtype!r}; expected one of "
            f"{list(TRANSFER_DTYPES)}") from None


def dequantize_transfer(audio: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`quantize_transfer`, keyed on dtype:
    int16 → /32768, uint8 → μ-law expansion, float32 passes through."""
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32768.0)
    if audio.dtype == torch.uint8:
        y = (audio.float() - 128.0) * (1.0 / 127.0)
        mu = torch.tensor(255.0, dtype=torch.float32, device=audio.device)
        return torch.sign(y) * (torch.expm1(y.abs() * torch.log1p(mu)) / mu)
    return audio


def _prepare(wavs: Sequence[np.ndarray], transfer_dtype: str,
             device: torch.device):
    lengths = np.asarray([len(w) for w in wavs], np.int32)
    width = _bucket(int(lengths.max()))
    rows = _batch_bucket(len(wavs))
    audio = np.zeros((rows, width), np.float32)
    for i, w in enumerate(wavs):
        audio[i, : len(w)] = np.asarray(w, np.float32)
    # pad rows are full-length silence: a zero-length row would send 0
    # through the conv length formula; every caller slices them off
    lengths = np.concatenate(
        [lengths, np.full(rows - len(wavs), width, np.int32)])
    audio = quantize_transfer(audio, transfer_dtype)
    return (torch.from_numpy(audio).to(device),
            torch.from_numpy(lengths).to(device))


def fetch_outputs(out: Dict) -> Dict[str, np.ndarray]:
    """A dict of tensors → host numpy: one device synchronisation, then
    one ``.cpu()`` pass (each copy then finds the device idle). A bf16
    tensor arrives as float32 (numpy has no bfloat16; the values are
    exact). Values that are not tensors pass through ``np.asarray``."""
    for v in out.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            break

    def host(v):
        v = v.cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    return {k: host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


def _tv_dict(tvs: np.ndarray) -> Dict[str, List[float]]:
    """(T, 9) → per-TV dict of lists, in TV_ORDER."""
    return {k: tvs[:, i].tolist() for i, k in enumerate(TV_ORDER)}


def _strip_pad_rows(out: Dict, n: int) -> Dict:
    """Slice every batch-leading output back to the caller's item count."""
    return {k: v[:n] for k, v in out.items()}


def check_fields(requested, available, owner: str) -> None:
    """Raise at the call site when ``fields=`` names outputs the forward
    does not produce."""
    unknown = set(requested) - set(available)
    if unknown:
        raise ValueError(
            f"unknown output field(s) {sorted(unknown)}; "
            f"{owner} produces {sorted(available)}")


def _log_softmax_host(logits: np.ndarray) -> np.ndarray:
    """Numerically stable log-softmax of fetched logits, on the host."""
    shifted = logits - logits.max(axis=-1, keepdims=True)
    return shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))


class _Predictor:
    def __init__(self, model, device: Union[str, torch.device, None] = None,
                 transfer_dtype: str = "float32"):
        """``model``: a model of this package (``APTAI``, ``W2V2PR``,
        ``ForceAPTAI``) with its weights loaded. The predictor serves a
        copy of it on ``device`` (``cuda`` unless named), in eval mode,
        whose encoder Linear and Conv1d weights are cast once to the
        compute dtype (bf16 under ``dtype="bfloat16"``; heads stay float32);
        ``model`` itself is left as it is.
        ``transfer_dtype``: "float32", "int16" (lossless for 16-bit PCM,
        half the upload) or "uint8_mulaw" (lossy, a quarter)."""
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                             f"expected one of {list(TRANSFER_DTYPES)}")
        self.device = resolve_device(device)
        serving = copy.deepcopy(model)
        cast_matmul_weights(serving.wav2vec2, compute_dtype(model.cfg))
        self.model = serving.to(self.device).eval()
        self.transfer_dtype = transfer_dtype


class APTAIPredictor(_Predictor):
    """Serves an :class:`aptai_tpu_torch.models.APTAI` (see
    :class:`_Predictor` for the serving copy, ``device`` and
    ``transfer_dtype``)."""

    @torch.inference_mode()
    def predict_batch(self, wavs: Sequence[np.ndarray],
                      fields: Optional[Sequence[str]] = None,
                      real_rows: Optional[int] = None) -> Dict:
        """Batched forward; every returned tensor has leading dim
        ``len(wavs)`` and stays on the device (no synchronisation).
        ``fields`` (e.g. ``("tvs_pred", "phn_fc_pred")``) restricts the
        outputs, and a head none of them needs is not run.
        ``real_rows`` (the MicroBatcher protocol) is accepted and ignored:
        pad rows cost only device work here."""
        del real_rows
        if fields is not None:
            check_fields(fields, PREDICT_FIELDS, "APTAI.predict")
        audio, lengths = _prepare(wavs, self.transfer_dtype, self.device)
        out = self.model.predict(dequantize_transfer(audio), lengths,
                                 fields=fields)
        return _strip_pad_rows(out, len(wavs))

    def get_aptai_output(self, wav) -> Dict:
        """Single-utterance dict of the reference schema (probs transposed
        to (V, T))."""
        out = self.predict_batch([np.asarray(wav, np.float32)])
        host = fetch_outputs({k: out[k] for k in (
            "frame_lengths", "phn_fc_probs", "phn_fc_logits",
            "phn_fc_pred", "tvs_pred")})
        n = int(host["frame_lengths"][0])
        return {
            "phn_fc_probs": host["phn_fc_probs"][0, :n].T,
            "phn_fc_logits": host["phn_fc_logits"][0, :n],
            "phn_fc_pred": host["phn_fc_pred"][0, :n],
            "tvs_pred": _tv_dict(host["tvs_pred"][0, :n]),
        }


class W2V2PRPredictor(_Predictor):
    def __init__(self, model, vocab: Optional[Dict[str, int]] = None,
                 device: Union[str, torch.device, None] = None,
                 transfer_dtype: str = "float32"):
        """``model``: an :class:`aptai_tpu_torch.models.W2V2PR`; ``vocab``
        (token → id) turns decoded ids into phonemes; see
        :class:`_Predictor` for the serving copy, ``device`` and
        ``transfer_dtype``."""
        super().__init__(model, device, transfer_dtype)
        self.vocab = vocab

    @torch.inference_mode()
    def encode_batch(self, wavs: Sequence[np.ndarray],
                     fields: Optional[Sequence[str]] = None,
                     real_rows: Optional[int] = None) -> Dict:
        """Batched encode: ``features_hidden`` (B, T, conv_dim[-1]),
        ``last_transf_hidden`` (B, T, hidden), ``phoneme_logits`` (B, T, V)
        float32 and ``frame_lengths``, every tensor with leading dim
        ``len(wavs)``, on the device (no synchronisation). ``fields``
        keeps only the named outputs (plus ``frame_lengths``).
        ``real_rows`` (the MicroBatcher protocol) is accepted and ignored:
        no per-row host work happens here."""
        del real_rows
        if fields is not None:
            check_fields(fields, ENCODE_FIELDS, "W2V2PR.encode")
        audio, lengths = _prepare(wavs, self.transfer_dtype, self.device)
        out = self.model.encode(dequantize_transfer(audio), lengths)
        if fields is not None:
            out = {k: v for k, v in out.items()
                   if k in fields or k == "frame_lengths"}
        return _strip_pad_rows(out, len(wavs))

    def get_embeddings(self, wavs: Sequence[np.ndarray]) -> Dict:
        """The reference's dict: conv features (B, C, T), final hidden
        states (B, H, T), logits (B, V, T), the beam-decoded id sequence of
        each item and the frame counts."""
        out = fetch_outputs(self.encode_batch(wavs))
        frame_lengths = out["frame_lengths"]
        logits = np.asarray(out["phoneme_logits"], np.float32)
        log_probs = _log_softmax_host(logits)
        seqs = [decode_best(log_probs[b, :frame_lengths[b]])
                for b in range(len(wavs))]
        return {
            "features_hidden": out["features_hidden"].transpose(0, 2, 1),
            "last_transf_hidden": out["last_transf_hidden"].transpose(0, 2, 1),
            "phoneme_logits": logits.transpose(0, 2, 1),
            "phn_pred_seq_idx": [np.asarray(s) for s in seqs],
            "frame_seq_lens": frame_lengths,
        }

    def get_ctc_logits(self, wav) -> np.ndarray:
        """(T, V) logits of one utterance, valid frames only."""
        out = fetch_outputs(self.encode_batch(
            [np.asarray(wav, np.float32)], fields=("phoneme_logits",)))
        n = int(out["frame_lengths"][0])
        return np.asarray(out["phoneme_logits"][0, :n])

    def predict_phonemes_durations(self, wav, vocab=None) -> Dict:
        """Beam-decoded ids, their phonemes (with a vocab) and each token's
        start time in seconds, ``frame · len(wav) / T / 16000``."""
        vocab = vocab or self.vocab
        wav = np.asarray(wav, np.float32)
        logits = self.get_ctc_logits(wav).astype(np.float32)
        tokens, times = decode_with_times(_log_softmax_host(logits))
        frame_sec_ratio = len(wav) / logits.shape[0] / SAMPLE_RATE
        return {
            "phn_seq_idx": np.asarray(tokens),
            "phn_seq_ipa": ids_to_phonemes(vocab, tokens) if vocab else None,
            "phn_seq_dur": [t * frame_sec_ratio for t in times],
        }

    def pred_phn_seq(self, wav, vocab=None) -> Dict:
        """Beam-decoded ids and their phonemes."""
        out = self.predict_phonemes_durations(wav, vocab)
        return {"phn_seq_idx": out["phn_seq_idx"],
                "phn_seq_ipa": out["phn_seq_ipa"]}


class ForceAPTAIPredictor(_Predictor):
    """Serves an :class:`aptai_tpu_torch.models.ForceAPTAI` (see
    :class:`_Predictor` for the serving copy, ``device`` and
    ``transfer_dtype``). A ``beam_host`` model runs split: the tower on
    the device, the C++ beam on the calling thread over the real rows
    only, then the head (``ForceAPTAI.predict_from_encoded``)."""

    def _encoded(self, audio, lengths, n: int):
        """The head's inputs on the split path; rows past ``n`` get
        zero-length sequences."""
        e = self.model.encode_and_decode(audio, lengths, n)
        return tuple(e[k] for k in ("frame_embs", "frame_lengths",
                                    "phn_pred_seq", "phn_seq_lengths",
                                    "phn_seq_truncated"))

    @torch.inference_mode()
    def predict_batch(self, wavs: Sequence[np.ndarray],
                      fields: Optional[Sequence[str]] = None,
                      real_rows: Optional[int] = None) -> Dict:
        """Batched forward; every returned tensor has leading dim
        ``len(wavs)`` and stays on the device. ``fields`` keeps only the
        named outputs (plus ``frame_lengths``). ``real_rows`` (the
        MicroBatcher protocol): only the first N wavs are real, and the
        ``beam_host`` path beam-decodes only those."""
        if fields is not None:
            check_fields(fields, force_aptai.PREDICT_FIELDS,
                         "ForceAPTAI.predict")
        audio, lengths = _prepare(wavs, self.transfer_dtype, self.device)
        audio = dequantize_transfer(audio)
        if self.model.decode_method == "beam_host":
            n = len(wavs) if real_rows is None else min(real_rows, len(wavs))
            out = self.model.predict_from_encoded(
                *self._encoded(audio, lengths, n))
        else:
            out = self.model.predict(audio, lengths)
        if fields is not None:
            out = {k: v for k, v in out.items()
                   if k in fields or k == "frame_lengths"}
        return _strip_pad_rows(out, len(wavs))

    def get_faptai_output(self, wav) -> Dict:
        """The reference's single-utterance dict: per-TV lists, the frame
        phonemes, the decoded sequence, the attention output and the
        BiLSTM output over the valid frames."""
        out = fetch_outputs(self.predict_batch([np.asarray(wav, np.float32)]))
        n = int(out["frame_lengths"][0])
        s = int(out["phn_seq_lengths"][0])
        return {
            "tvs_pred": _tv_dict(out["tvs_pred"][0, :n]),
            "pred_frame_phns": out["pred_frame_phns"][0, :n].tolist(),
            "pred_ctc_phn_seq": out["pred_ctc_phn_seq"][0, :s].tolist(),
            "hidden_alignment": out["hidden_alignment"][0, :n],
            "hidden_tvs": out["hidden_tvs"][0, :n],
        }

    @torch.inference_mode()
    def get_alignment(self, wav) -> Dict:
        """``{"alignment": (phonemes × frames)}``: the log-softmax
        alignment of one utterance over its decoded phonemes and valid
        frames."""
        audio, lengths = _prepare([np.asarray(wav, np.float32)],
                                  self.transfer_dtype, self.device)
        audio = dequantize_transfer(audio)
        if self.model.decode_method == "beam_host":
            out = self.model.alignment_from_encoded(
                *self._encoded(audio, lengths, 1))
        else:
            out = self.model.get_alignment(audio, lengths)
        host = fetch_outputs({k: out[k] for k in (
            "frame_lengths", "phn_seq_lengths", "alignment")})
        n = int(host["frame_lengths"][0])
        s = int(host["phn_seq_lengths"][0])
        return {"alignment": host["alignment"][0, :n, :s].T}
