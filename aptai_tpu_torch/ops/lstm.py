"""Length-masked (bi)LSTM over a padded batch, with packed-sequence
semantics (the JAX package's ``ops/lstm.py``, there a masked ``lax.scan``).

Contract, the JAX package's and the reference's ``nn.LSTM`` fed packed
sequences:

* torch ``nn.LSTM`` gate math: gate order (i, f, g, o), two bias vectors;
* outputs are zero past each item's length;
* final states ``(h_n, c_n)`` are taken at each item's true end;
* the backward direction starts at each item's true last frame.

Here the batch is packed (``pack_padded_sequence``) and runs through the
LSTM operator of ``nn.LSTM`` (cuDNN on the card), which gives all four
properties directly. Packing sorts by length on the host, so the lengths
are read to the host: one device synchronisation a call when they live on
the card. A length of 0 cannot be packed; such a row runs with length 1 and
its outputs and states are zeroed afterwards, which is what the masked scan
gives (no step taken from zero states).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)


class LSTMParams(NamedTuple):
    """Weights in torch layout: w_ih (4H, I), w_hh (4H, H), b_ih (4H,),
    b_hh (4H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor


def _packed_lstm(x: torch.Tensor, lengths: torch.Tensor,
                 weights: Sequence[torch.Tensor], bidirectional: bool):
    """``nn.LSTM``'s operator over ``x`` (B, T, I) packed by ``lengths``:
    ``(outputs (B, T, D·H), h_n (D, B, H), c_n (D, B, H))``, D directions,
    with the zero-length rows zeroed."""
    b, t, _ = x.shape
    hdim = weights[1].shape[1]
    dirs = 2 if bidirectional else 1
    host_lengths = lengths.detach().to("cpu", torch.int64)
    empty = host_lengths == 0
    packed = pack_padded_sequence(x, host_lengths.clamp(min=1),
                                  batch_first=True, enforce_sorted=False)
    h0 = x.new_zeros((dirs, b, hdim))
    # cuDNN keeps what its backward needs only in "training" mode; with no
    # dropout the flag changes nothing else
    out, h_n, c_n = torch._VF.lstm(
        packed.data, packed.batch_sizes, (h0, h0), list(weights), True, 1,
        0.0, torch.is_grad_enabled(), bidirectional)
    out, _ = pad_packed_sequence(
        PackedSequence(out, packed.batch_sizes, packed.sorted_indices,
                       packed.unsorted_indices),
        batch_first=True, total_length=t)
    h_n = h_n.index_select(1, packed.unsorted_indices)
    c_n = c_n.index_select(1, packed.unsorted_indices)
    if bool(empty.any()):
        keep = (~empty).to(x.device, x.dtype)
        out = out * keep[:, None, None]
        h_n = h_n * keep[None, :, None]
        c_n = c_n * keep[None, :, None]
    return out, h_n, c_n


def lstm(x: torch.Tensor, lengths: torch.Tensor, params: LSTMParams,
         reverse: bool = False):
    """One direction over a padded batch.

    ``x`` (B, T, I), ``lengths`` (B,) valid frames; ``reverse`` runs
    right-to-left within each item's valid region. Returns ``(outputs
    (B, T, H), (h_n, c_n))``, outputs zero past each length, the states
    (B, H) at each item's true end."""
    if not reverse:
        out, h_n, c_n = _packed_lstm(x, lengths, list(params), False)
        return out, (h_n[0], c_n[0])
    # reverse each item within its length, run forward, reverse back
    t = x.shape[1]
    lengths = lengths.to(x.device, torch.int64)
    steps = torch.arange(t, device=x.device)
    idx = (lengths[:, None] - 1 - steps[None, :]).clamp(min=0)
    x_rev = x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    out, h_n, c_n = _packed_lstm(x_rev, lengths, list(params), False)
    out = out.gather(1, idx[:, :, None].expand(-1, -1, out.shape[2]))
    out = out * (steps[None, :] < lengths[:, None]).to(out.dtype)[:, :, None]
    return out, (h_n[0], c_n[0])


def bilstm(x: torch.Tensor, lengths: torch.Tensor, fwd: LSTMParams,
           bwd: LSTMParams) -> Tuple[torch.Tensor, Tuple]:
    """Bidirectional LSTM, ``nn.LSTM(bidirectional=True,
    batch_first=True)`` over packed sequences: ``(outputs (B, T, 2H) =
    [forward ‖ backward], ((h_f, c_f), (h_b, c_b)))``."""
    out, h_n, c_n = _packed_lstm(x, lengths, list(fwd) + list(bwd), True)
    return out, ((h_n[0], c_n[0]), (h_n[1], c_n[1]))
