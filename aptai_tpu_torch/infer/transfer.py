"""The host/device transfer of the serving paths: the device an entry point
runs on, the wire encodings of uploaded audio (float32, int16, 8-bit μ-law)
and their inverse on the device, and the fetch of a batch's outputs to the
host.

Kept apart from the predictors (``infer/api.py``) so that a serving bundle
(``infer/export.py``) loads and runs without the model code.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch


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
