"""ForceAPTAI: forced-alignment TV regression over a frozen phoneme
recognizer (the JAX package's ``models/force_aptai.py``).

  frozen W2V2PR tower (eval, no gradient) → frame embeddings + CTC logits
  → in-step decode of the phoneme sequence (≤ 60 ids, pad 0)
  → phoneme embedding + sinusoidal PE ↔ projected frames: cross-attention
  → alignment log-softmax (ForwardSum loss) and BiLSTM TV head
  → FIR low-pass; loss = 0.4·MSE + 0.6·ForwardSum (+ aux frame CE).

Head dims are the reference's (force_aptai.py:28-34): frame, phoneme and
attention hidden 128, BiLSTM hidden 256 a direction, dropouts 0.2 / 0.1.
The head runs in float32 whatever the tower's dtype.

The tower is frozen whatever the outer mode: its parameters do not require
a gradient (so ``torch_adam`` gives them no state), it stays in ``eval()``
when the model is put in ``train()`` (no dropout or SpecAugment), and it
runs under ``torch.no_grad()``.

``decode_method``:

* ``"greedy"`` — the batched on-device collapse
  (:func:`aptai_tpu_torch.ops.ctc.greedy_decode`);
* ``"beam_host"`` — the reference's host beam search. Its path is split:
  :meth:`encode_and_decode` (the tower, then the C++ beam on the calling
  thread) → the ``*_from_encoded`` methods, as the predictor and the
  trainer adapters run it. The full forward refuses it unless
  ``allow_host_callback_decode=True``, as the JAX package does, and then
  decodes on the calling thread;
* ``"beam_device"`` — the batched beam search on the tower's device
  (:func:`aptai_tpu_torch.decode.device.beam_decode_device`, through its
  op ``aptai_torch::beam_decode``), every row,
  inside the forward as greedy is.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch import FRAME_RATE_HZ, TV_PAD_VALUE
from aptai_tpu_torch.decode.beam import beam_decode_padded
from aptai_tpu_torch.decode.device import beam_decode
from aptai_tpu_torch.models.aptai import NUM_TVS, _pad_or_trim
from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.models.modules import (CrossAttention, PhonemeEncoder,
                                            RNNHead, dropout)
from aptai_tpu_torch.models.w2v2_pr import W2V2PR
from aptai_tpu_torch.models.wav2vec2 import init_weights_
from aptai_tpu_torch.ops.ctc import greedy_decode
from aptai_tpu_torch.ops.fir import fir_lowpass, lowpass_fir_taps
from aptai_tpu_torch.ops.forward_sum import forward_sum_loss
from aptai_tpu_torch.parallel.global_batch import global_mean

DECODE_METHODS = ("greedy", "beam_host", "beam_device")
PREDICT_FIELDS = ("tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
                  "phn_seq_lengths", "phn_seq_truncated", "hidden_alignment",
                  "hidden_tvs", "frame_lengths")
# the reference's weight of the TV MSE in the loss (force_aptai.py:144)
TV_LOSS_WEIGHT = 0.4


class ForceAPTAI(nn.Module):
    def __init__(self, pr_cfg: Wav2Vec2Config, vocab_size: int = 46,
                 hidden_drop: float = 0.2, rnn_drop: float = 0.1,
                 max_phn_seq_len: int = 60, frame_hidden_dim: int = 128,
                 phn_hidden_dim: int = 128, att_hidden_dim: int = 128,
                 lowpass_cutoff_hz: float = 10.0,
                 frame_rate_hz: float = float(FRAME_RATE_HZ),
                 blank_logprob: float = -1.0, off_diag_prior: bool = False,
                 prior_g: float = 0.2, energy_temperature: float = 1.0,
                 aux_frame_ce_weight: float = 0.0,
                 frame_hidden_layer: int = -1,
                 decode_method: str = "greedy",
                 allow_host_callback_decode: bool = False):
        """The knobs are the JAX package's: ``blank_logprob`` scores the
        ForwardSum blank column; ``off_diag_prior`` / ``prior_g`` add the
        Gaussian band prior to its scores; ``energy_temperature`` divides
        the attention energies before the alignment log-softmax;
        ``aux_frame_ce_weight`` > 0 adds the frame CE that distils the
        tower's per-frame CTC argmax into the alignment;
        ``frame_hidden_layer`` ≥ 0 feeds that tower hidden state (HF
        indexing) to the frame path in place of the final one."""
        super().__init__()
        if decode_method not in DECODE_METHODS:
            raise ValueError(f"decode_method must be one of "
                             f"{DECODE_METHODS}, got {decode_method!r}")
        self.cfg = pr_cfg
        self.vocab_size = vocab_size
        self.hidden_drop = hidden_drop
        self.max_phn_seq_len = max_phn_seq_len
        self.blank_logprob = blank_logprob
        self.off_diag_prior = off_diag_prior
        self.prior_g = prior_g
        self.energy_temperature = energy_temperature
        self.aux_frame_ce_weight = aux_frame_ce_weight
        self.frame_hidden_layer = frame_hidden_layer
        self.decode_method = decode_method
        self.allow_host_callback_decode = allow_host_callback_decode

        self.w2v2_pr = W2V2PR(pr_cfg).eval()
        self.w2v2_pr.requires_grad_(False)
        self.xatt = CrossAttention(frame_hidden_dim, phn_hidden_dim,
                                   att_hidden_dim)
        self.frame_lin = nn.Linear(pr_cfg.hidden_size, frame_hidden_dim)
        self.phn_encoder = PhonemeEncoder(vocab_size, phn_hidden_dim,
                                          max_phn_seq_len, hidden_drop)
        self.rnn = RNNHead(2 * att_hidden_dim, 2 * att_hidden_dim, NUM_TVS,
                           rnn_drop)
        taps = lowpass_fir_taps(lowpass_cutoff_hz, frame_rate_hz)
        self.register_buffer("fir_taps",
                             torch.tensor(taps, dtype=torch.float32),
                             persistent=False)

    @property
    def wav2vec2(self):
        """The tower's encoder (the predictors cast its weights)."""
        return self.w2v2_pr.wav2vec2

    def train(self, mode: bool = True):
        super().train(mode)
        self.w2v2_pr.eval()  # frozen: never dropout or SpecAugment
        return self

    # -- the frozen tower -----------------------------------------------------

    @torch.no_grad()
    def encode_frozen(self, audio_inputs: torch.Tensor,
                      audio_lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The tower's half of the forward: ``frame_embs`` (B, T, hidden)
        in the tower's dtype, ``ctc_log_probs`` (B, T, V) float32,
        ``logits`` and ``frame_lengths``, all without a gradient."""
        if self.frame_hidden_layer >= 0:
            out = self.w2v2_pr.encode_layers(
                audio_inputs, audio_lengths,
                intermediate_hidden=self.frame_hidden_layer,
                latter_hidden=self.frame_hidden_layer)
            frame_embs = out["intermediate_hidden"]
            logits = out["phoneme_logits_last"]
        else:
            out = self.w2v2_pr.encode(audio_inputs, audio_lengths)
            frame_embs = out["last_transf_hidden"]
            logits = out["phoneme_logits"]
        return {"frame_embs": frame_embs,
                "ctc_log_probs": F.log_softmax(logits.float(), dim=-1),
                "logits": logits, "frame_lengths": out["frame_lengths"]}

    def decode(self, enc: Dict[str, torch.Tensor],
               n_real: Optional[int] = None):
        """The decode of ``encode_frozen``'s outputs: ``(seqs (B, 60)
        int32, lengths (B,), truncated (B,))`` on their device. Greedy and
        ``beam_device`` decode every row on the device (the beam from the
        float32 log-probs); ``beam_host`` beam-searches the first
        ``n_real`` rows (all by default) on the calling thread and gives
        the others zero-length sequences."""
        fl = enc["frame_lengths"]
        if self.decode_method == "greedy":
            return greedy_decode(enc["logits"], fl, blank=0,
                                 max_output_length=self.max_phn_seq_len,
                                 return_truncated=True)
        if self.decode_method == "beam_device":
            return beam_decode(enc["ctc_log_probs"], fl, 0, 10, 50.0,
                               self.max_phn_seq_len)
        n = fl.shape[0] if n_real is None else n_real
        return tuple(torch.from_numpy(x).to(fl.device) for x in
                     beam_decode_padded(enc["ctc_log_probs"][:n], fl[:n],
                                        self.max_phn_seq_len,
                                        out_rows=fl.shape[0]))

    def encode_and_decode(self, audio_inputs: torch.Tensor,
                          audio_lengths: torch.Tensor,
                          n_real: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """:meth:`encode_frozen`, then :meth:`decode` (``n_real`` as
        there): ``frame_embs``, ``frame_lengths``, ``phn_pred_seq``,
        ``phn_seq_lengths``, ``phn_seq_truncated`` and
        ``tower_frame_labels`` (the tower's per-frame CTC argmax, for the
        aux frame CE), the inputs of the ``*_from_encoded`` methods."""
        enc = self.encode_frozen(audio_inputs, audio_lengths)
        seqs, lens, trunc = self.decode(enc, n_real)
        return {"frame_embs": enc["frame_embs"],
                "frame_lengths": enc["frame_lengths"],
                "phn_pred_seq": seqs, "phn_seq_lengths": lens,
                "phn_seq_truncated": trunc,
                "tower_frame_labels": enc["ctc_log_probs"].argmax(-1).to(
                    torch.int32)}

    def _align(self, audio_inputs, audio_lengths, generator):
        if (self.decode_method == "beam_host"
                and not self.allow_host_callback_decode):
            raise ValueError(
                "decode_method='beam_host' runs the host beam search inside "
                "the forward; use the split path instead (encode_and_decode "
                "-> train_from_encoded / predict_from_encoded, as "
                "ForceAPTAIPredictor and the trainer adapters do), or "
                "construct the model with allow_host_callback_decode=True "
                "for single-threaded experiment use")
        e = self.encode_and_decode(audio_inputs, audio_lengths)
        return self._align_core(
            e["frame_embs"], e["frame_lengths"], e["phn_pred_seq"],
            e["phn_seq_lengths"], e["phn_seq_truncated"], generator,
            e["tower_frame_labels"])

    # -- the head -------------------------------------------------------------

    def _align_core(self, frame_embs, frame_lengths, phn_pred_seq,
                    phn_seq_lengths, phn_seq_truncated, generator=None,
                    tower_frame_labels=None):
        """Phoneme embedding ↔ frame cross-attention. The pad mask enters
        twice, as in the JAX package: ``CrossAttention`` returns the
        energies with it, and it is added again after the temperature."""
        phn_mask = (phn_pred_seq != 0).to(torch.int32)
        phn_embs = self.phn_encoder(phn_pred_seq, generator)
        frame_hidden = dropout(self.frame_lin(frame_embs.float()),
                               self.hidden_drop, self.training, generator)
        att_out, energy = self.xatt(frame_hidden, phn_embs, phn_mask)
        att_mask = (1 - phn_mask).to(energy.dtype) * -1000.0
        if self.energy_temperature != 1.0:
            energy = energy / self.energy_temperature
        att = F.log_softmax(energy + att_mask[:, None, :], dim=-1)
        return {"att_out": att_out, "att": att, "phn_pred_seq": phn_pred_seq,
                "phn_seq_lengths": phn_seq_lengths,
                "phn_seq_truncated": phn_seq_truncated,
                "frame_lengths": frame_lengths,
                "tower_frame_labels": tower_frame_labels}

    def _frame_phonemes(self, a):
        """The frame's phoneme: the alignment's argmax through the decoded
        sequence (force_aptai.py:147-161)."""
        return torch.gather(a["phn_pred_seq"], 1, a["att"].argmax(-1))

    def _train_out(self, a, tv_targets, generator):
        frame_lengths = a["frame_lengths"]
        t = a["att_out"].shape[1]
        tv_targets = _pad_or_trim(tv_targets.to(frame_lengths.device).float(),
                                  t, TV_PAD_VALUE)
        rnn_out, _ = self.rnn(a["att_out"], frame_lengths, generator)
        tvs = fir_lowpass(rnn_out, self.fir_taps)

        tv_mask = (tv_targets != TV_PAD_VALUE).float()
        # the masked means are over the (global) batch's frames
        tv_loss = global_mean((tv_mask * (tvs - tv_targets) ** 2).sum(),
                              tv_mask.sum())
        align_loss = forward_sum_loss(
            a["att"], a["phn_seq_lengths"], frame_lengths,
            blank_logprob=self.blank_logprob,
            off_diag_prior=self.off_diag_prior, prior_g=self.prior_g)
        loss = (TV_LOSS_WEIGHT * tv_loss
                + (1 - TV_LOSS_WEIGHT) * align_loss)

        aux_ce = tvs.new_zeros(())
        labels = a["tower_frame_labels"]
        if self.aux_frame_ce_weight > 0 and labels is not None:
            # attention mass on the decoded positions holding the tower's
            # phone, over the frames where that phone is not blank
            tl = labels[:, :t].to(frame_lengths.device)
            match = a["phn_pred_seq"][:, None, :] == tl[:, :, None]
            p_match = (a["att"].exp() * match).sum(-1)
            in_len = (torch.arange(t, device=tl.device)[None, :]
                      < frame_lengths[:, None])
            valid = (tl != 0) & in_len
            ce = -torch.log(p_match.clamp(min=1e-8))
            aux_ce = global_mean(
                torch.where(valid, ce, torch.zeros_like(ce)).sum(),
                valid.sum())
            loss = loss + self.aux_frame_ce_weight * aux_ce

        return {"loss": loss, "tv_loss": tv_loss, "align_loss": align_loss,
                "aux_ce": aux_ce, "tvs_pred": tvs,
                "pred_frame_phns": self._frame_phonemes(a),
                "pred_ctc_phn_seq": a["phn_pred_seq"],
                "phn_seq_lengths": a["phn_seq_lengths"],
                "phn_seq_truncated": a["phn_seq_truncated"],
                "frame_lengths": frame_lengths}

    def _predict_out(self, a):
        rnn_out, hidden = self.rnn(a["att_out"], a["frame_lengths"])
        return {"tvs_pred": fir_lowpass(rnn_out, self.fir_taps),
                "pred_frame_phns": self._frame_phonemes(a),
                "pred_ctc_phn_seq": a["phn_pred_seq"],
                "phn_seq_lengths": a["phn_seq_lengths"],
                "phn_seq_truncated": a["phn_seq_truncated"],
                "hidden_alignment": a["att_out"], "hidden_tvs": hidden,
                "frame_lengths": a["frame_lengths"]}

    @staticmethod
    def _alignment_out(a):
        return {"alignment": a["att"], "phn_pred_seq": a["phn_pred_seq"],
                "phn_seq_lengths": a["phn_seq_lengths"],
                "frame_lengths": a["frame_lengths"]}

    # -- entry points ---------------------------------------------------------

    def forward(self, audio_inputs: torch.Tensor,
                audio_lengths: torch.Tensor, tv_targets: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The training forward (the JAX ``__call__``): ``audio_inputs``
        (B, L), ``audio_lengths`` (B,) in samples, ``tv_targets`` (B, T, 9)
        in TV_ORDER (pad −100). Returns ``loss``, ``tv_loss``,
        ``align_loss``, ``aux_ce``, ``tvs_pred``, ``pred_frame_phns``,
        ``pred_ctc_phn_seq``, ``phn_seq_lengths``, ``phn_seq_truncated``
        and ``frame_lengths``. The head's dropout acts in ``train()``
        mode, drawn from ``generator``."""
        a = self._align(audio_inputs, audio_lengths, generator)
        return self._train_out(a, tv_targets, generator)

    def train_from_encoded(self, frame_embs, frame_lengths, phn_pred_seq,
                           phn_seq_lengths, phn_seq_truncated, tv_targets,
                           generator: Optional[torch.Generator] = None,
                           tower_frame_labels=None):
        """``forward`` from the tower's outputs (``encode_frozen``) and
        decoded sequences: the head alone. ``tower_frame_labels`` (B, T),
        the tower's per-frame CTC argmax, feeds the aux CE; without it
        that term is skipped."""
        a = self._align_core(frame_embs, frame_lengths, phn_pred_seq,
                             phn_seq_lengths, phn_seq_truncated, generator,
                             tower_frame_labels)
        return self._train_out(a, tv_targets, generator)

    def predict(self, audio_inputs, audio_lengths) -> Dict[str, torch.Tensor]:
        """The batched core of ``get_faptai_output``: smoothed TVs, frame
        phonemes, the decoded sequence, the attention output
        (``hidden_alignment``) and the BiLSTM output (``hidden_tvs``)."""
        return self._predict_out(self._align(audio_inputs, audio_lengths,
                                             None))

    def predict_from_encoded(self, frame_embs, frame_lengths, phn_pred_seq,
                             phn_seq_lengths, phn_seq_truncated):
        """``predict`` from the tower's outputs and decoded sequences."""
        return self._predict_out(self._align_core(
            frame_embs, frame_lengths, phn_pred_seq, phn_seq_lengths,
            phn_seq_truncated))

    def get_alignment(self, audio_inputs, audio_lengths):
        """The (B, T, N) log-softmax alignment with the decoded sequence."""
        return self._alignment_out(self._align(audio_inputs, audio_lengths,
                                               None))

    def alignment_from_encoded(self, frame_embs, frame_lengths, phn_pred_seq,
                               phn_seq_lengths, phn_seq_truncated):
        """``get_alignment`` from the tower's outputs and decoded
        sequences."""
        return self._alignment_out(self._align_core(
            frame_embs, frame_lengths, phn_pred_seq, phn_seq_lengths,
            phn_seq_truncated))


def random_force_aptai(cfg: Wav2Vec2Config, seed: int = 0,
                       **kwargs) -> ForceAPTAI:
    """A ForceAPTAI with random weights drawn from ``seed`` (CPU
    generator, so the same seed gives the same weights on any machine);
    ``kwargs`` go to :class:`ForceAPTAI`."""
    model = ForceAPTAI(cfg, **kwargs)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model
