"""W2V2PR: the wav2vec2 CTC phoneme recognizer.

  wav2vec2 encoder → final dropout (``train()`` only) → ``pr_head``
  (Linear hidden → vocab, computed in float32 whatever ``cfg.dtype`` is, as
  the JAX package's ``nn.Dense`` without a dtype promotes bf16 hidden states
  and float32 weights) → float32 log-softmax → CTC loss (``ops.ctc``).

Targets are padded with −100: a target's length is its count of labels
≥ 0, and the labels are clamped to 0. The feature encoder is trainable by
default (freeze it with ``freeze_feature_encoder=True``); under
``cfg.fused_feature_extractor`` a trainable one raises in a forward that
needs its gradient, since the fused op has no backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model, init_weights_
from aptai_tpu_torch.ops.ctc import ctc_loss

ENCODE_FIELDS = ("features_hidden", "last_transf_hidden", "phoneme_logits",
                 "frame_lengths")


class W2V2PR(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config,
                 freeze_feature_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(
            cfg, freeze_feature_encoder=freeze_feature_encoder)
        self.pr_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def final_dropout(self, hidden: torch.Tensor) -> torch.Tensor:
        rate = self.cfg.final_dropout
        return F.dropout(hidden, rate) if self.training and rate else hidden

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """``pr_head`` in float32: (B, T, hidden) → (B, T, vocab) logits."""
        return self.pr_head(hidden.float())

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor, phoneme_labels: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The training forward: ``input_values`` (B, L), ``input_lengths``
        (B,) in samples, ``phoneme_labels`` (B, S) padded with −100.
        Returns ``loss``, ``phoneme_logits``, ``log_probs``,
        ``hidden_states`` (after the final dropout) and ``frame_lengths``.
        Dropout and SpecAugment act in ``train()`` mode (SpecAugment's
        spans from ``generator``)."""
        hidden, frame_lengths, _ = self.wav2vec2(input_values, input_lengths,
                                                 generator=generator)
        return self._ctc_out(hidden, frame_lengths, phoneme_labels)

    def train_from_features(self, fe_features: torch.Tensor,
                            input_lengths: torch.Tensor,
                            phoneme_labels: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
        """``forward`` from the frozen feature extractor's cached output
        (B, T, conv_dim[-1]); ``input_lengths`` stays in samples."""
        hidden, frame_lengths, _ = self.wav2vec2(
            None, input_lengths, precomputed_features=fe_features,
            generator=generator)
        return self._ctc_out(hidden, frame_lengths, phoneme_labels)

    def _ctc_out(self, hidden, frame_lengths, phoneme_labels):
        hidden = self.final_dropout(hidden)
        logits = self.head(hidden)
        log_probs = F.log_softmax(logits, dim=-1)
        labels = phoneme_labels.to(hidden.device)
        target_lengths = (labels >= 0).sum(dim=-1).to(torch.int32)
        targets = labels.clamp(min=0).to(torch.int32)
        loss = ctc_loss(log_probs, frame_lengths, targets, target_lengths,
                        blank=self.cfg.blank_id,
                        reduction=self.cfg.ctc_loss_reduction,
                        zero_infinity=self.cfg.ctc_zero_infinity)
        return {
            "loss": loss,
            "phoneme_logits": logits,
            "log_probs": log_probs,
            "hidden_states": hidden,
            "frame_lengths": frame_lengths,
        }

    def encode_layers(self, input_values: torch.Tensor,
                      input_lengths: torch.Tensor,
                      intermediate_hidden: int = 12,
                      latter_hidden: int = 20) -> Dict[str, torch.Tensor]:
        """CTC logits from the final, an intermediate and a latter layer's
        hidden states (HF ``hidden_states`` indexing: entry 0 is the first
        layer's input, entry N the encoder's output)."""
        hidden, frame_lengths, feats, all_hidden = self.wav2vec2(
            input_values, input_lengths, output_hidden_states=True)
        inter = all_hidden[intermediate_hidden]
        latter = all_hidden[latter_hidden]
        return {
            "features_hidden": feats,
            "last_transf_hidden": hidden,
            "phoneme_logits_last": self.head(hidden),
            "phoneme_logits_inter": self.head(inter),
            "phoneme_logits_latter": self.head(latter),
            "intermediate_hidden": inter,
            "latter_hidden": latter,
            "frame_lengths": frame_lengths,
        }

    def encode(self, input_values: torch.Tensor,
               input_lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Conv features, final hidden states and CTC logits: the device
        side of ``W2V2PRPredictor``; the beam search runs on the host."""
        hidden, frame_lengths, feats = self.wav2vec2(input_values,
                                                     input_lengths)
        return {
            "features_hidden": feats,
            "last_transf_hidden": hidden,
            "phoneme_logits": self.head(hidden),
            "frame_lengths": frame_lengths,
        }


def random_w2v2_pr(cfg: Wav2Vec2Config, seed: int = 0,
                   **kwargs) -> W2V2PR:
    """A W2V2PR with random weights drawn from ``seed`` (CPU generator, so
    the same seed gives the same weights on any machine); ``kwargs`` go to
    :class:`W2V2PR`."""
    model = W2V2PR(cfg, **kwargs)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model
