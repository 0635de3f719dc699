"""The FORCE-APTAI head's modules (the JAX package's ``models/modules.py``).

* :class:`CrossAttention`: frames (queries) against decoded phonemes
  (keys) with an additive −1000 pad mask (reference models/modules.py:
  129-153);
* :func:`sinusoidal_positional_encoding` and :class:`PhonemeEncoder`:
  embedding + sinusoidal PE of a decoded phoneme sequence (reference
  models/modules.py:217-235, force_aptai.py:47-56);
* :class:`RNNHead`: BiLSTM (packed-sequence semantics, ``ops.lstm``) and a
  Linear → Dropout → Tanh → Linear TV regressor (reference
  models/modules.py:190-214);
* :class:`ConvBank`: the conv-bank phoneme classifier that the reference
  defines and no model uses (models/modules.py:156-187), kept for API
  parity.

Dropout acts in ``train()`` mode and draws from ``generator`` when one is
given (a generator on the tensors' device), else from the default one.
LayerNorm uses Flax's eps 1e-6, not torch's 1e-5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch.ops.lstm import LSTMParams, bilstm

FLAX_LN_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout at ``rate`` in training, its mask drawn from
    ``generator`` (the default generator when None)."""
    if not training or not rate:
        return x
    if generator is None:
        return F.dropout(x, rate, training=True)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class CrossAttention(nn.Module):
    """Q = projected frames, K = projected phonemes, additive −1000 pad mask.

    ``forward(frame_hidden (B, T, Fq), phn_hidden (B, N, Fk), phn_mask
    (B, N))`` returns ``(att_out, energy)``: ``att_out = LayerNorm(
    [softmax(energy)·K ‖ Q])`` (B, T, 2A), and ``energy`` (B, T, N) = Q·Kᵀ
    with the −1000 pad mask already added."""

    def __init__(self, q_dim: int, k_dim: int, att_dim: int = 128):
        super().__init__()
        self.q = nn.Linear(q_dim, att_dim)
        self.k = nn.Linear(k_dim, att_dim)
        self.layer_norm = nn.LayerNorm(2 * att_dim, eps=FLAX_LN_EPS)

    def forward(self, frame_hidden, phn_hidden, phn_mask
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = self.q(frame_hidden)
        k = self.k(phn_hidden)
        energy = torch.einsum("bta,bna->btn", q, k)
        att_mask = (1.0 - phn_mask.to(energy.dtype)) * -1000.0
        energy = energy + att_mask[:, None, :]
        att = torch.softmax(energy, dim=-1)
        att_out = torch.cat([torch.einsum("btn,bna->bta", att, k), q], dim=-1)
        return self.layer_norm(att_out), energy


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) sin/cos table, built in float64 and returned as
    float32 (reference models/modules.py:222-227)."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float64)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class PhonemeEncoder(nn.Module):
    """Embedding + sinusoidal PE + dropout over decoded phoneme ids (B, N).

    The rows looked up for id 0 (pad and blank) are zeroed in the forward,
    as the JAX package masks them, so a loaded table with a nonzero row 0
    stays inert (``padding_idx=0`` alone only starts that row at zero and
    keeps its gradient off). The PE is added at every position, pads
    included."""

    def __init__(self, vocab_size: int, dim: int = 128, max_len: int = 60,
                 dropout: float = 0.2):
        super().__init__()
        self.rate = dropout
        self.embed = nn.Embedding(vocab_size, dim, padding_idx=0)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positional_encoding(max_len,
                                                                  dim)),
            persistent=False)

    def forward(self, phn_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = phn_ids.long()
        emb = self.embed(ids).masked_fill((ids == 0)[:, :, None], 0.0)
        emb = emb + self.pe[None, :emb.shape[1]]
        return dropout(emb, self.rate, self.training, generator)


class RNNHead(nn.Module):
    """BiLSTM + [Linear → Dropout → Tanh → Linear] TV regressor.

    ``forward(x (B, T, I), lengths (B,))`` returns ``(tvs (B, T, out_dim),
    hidden (B, T, 2H))``, hidden being the BiLSTM output (zero past each
    length). The lengths are read to the host (``ops.lstm``)."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, out_dim: int = 9,
                 dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.lstm = nn.LSTM(in_dim, hidden_dim, batch_first=True,
                            bidirectional=True)
        self.linear_0 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.linear_1 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x, lengths,
                generator: Optional[torch.Generator] = None):
        m = self.lstm
        fwd = LSTMParams(m.weight_ih_l0, m.weight_hh_l0, m.bias_ih_l0,
                         m.bias_hh_l0)
        bwd = LSTMParams(m.weight_ih_l0_reverse, m.weight_hh_l0_reverse,
                         m.bias_ih_l0_reverse, m.bias_hh_l0_reverse)
        hidden, _ = bilstm(x, lengths, fwd, bwd)
        out = dropout(self.linear_0(hidden), self.rate, self.training,
                      generator)
        return self.linear_1(torch.tanh(out)), hidden


class ConvBank(nn.Module):
    """Conv-bank phoneme classifier over (B, T, in_dim) features: tanh
    Linear → dropout → one 'same' conv per kernel size, concatenated →
    tanh → dropout → Linear."""

    def __init__(self, in_dim: int, output_class_num: int,
                 kernels: Tuple[int, ...] = (3, 5, 7), cnn_size: int = 32,
                 hidden_size: int = 64, dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.in_linear = nn.Linear(in_dim, hidden_size)
        self.cnns = nn.ModuleList(
            nn.Conv1d(hidden_size, cnn_size, k, padding=k // 2)
            for k in kernels)
        self.out_linear = nn.Linear(cnn_size * len(kernels),
                                    output_class_num)

    def forward(self, features,
                generator: Optional[torch.Generator] = None):
        h = torch.tanh(self.in_linear(features))
        h = dropout(h, self.rate, self.training, generator).transpose(1, 2)
        h = torch.tanh(torch.cat([conv(h) for conv in self.cnns], dim=1))
        h = dropout(h.transpose(1, 2), self.rate, self.training, generator)
        return self.out_linear(h)
