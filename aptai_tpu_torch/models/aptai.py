"""APTAI: tract-variable regression + frame-level phoneme classification on
the wav2vec2 encoder.

  * TV head: Dropout(tv_drop) → Tanh (in the compute dtype) → float32 →
    Linear(hidden → 9), then the windowed-sinc low-pass (cutoff 10 Hz at
    the 49 Hz frame rate) over the whole padded frame axis;
  * phoneme head: Dropout(phn_drop) → LeakyReLU(0.01) (in the compute
    dtype) → float32 → Linear(hidden → num_phonemes);
  * training loss (``forward``): 0.5 · masked MSE over TV frames that are
    not the −100 pad + 0.5 · masked cross-entropy over phoneme frames that
    are not 0, each divided by max(count, 1).

Both heads' Linear layers stay float32 whatever ``cfg.dtype`` is. The
feature encoder is frozen by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch import FRAME_RATE_HZ, TV_PAD_VALUE
from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model, init_weights_
from aptai_tpu_torch.ops.fir import fir_lowpass, lowpass_fir_taps
from aptai_tpu_torch.parallel.global_batch import global_mean

NUM_TVS = 9

PREDICT_FIELDS = ("phn_fc_probs", "phn_fc_logits", "phn_fc_pred",
                  "tvs_pred", "frame_lengths")
_PHN_FIELDS = frozenset(PREDICT_FIELDS[:3])


def _pad_or_trim(x: torch.Tensor, t: int, value) -> torch.Tensor:
    """Reconcile axis 1 with ``t`` frames: pad with ``value`` or trim."""
    cur = x.shape[1]
    if cur >= t:
        return x[:, :t]
    pad = x.new_full((x.shape[0], t - cur) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


class APTAI(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, num_phonemes: int = 46,
                 lowpass_cutoff_hz: float = 10.0,
                 frame_rate_hz: float = float(FRAME_RATE_HZ),
                 tv_drop: float = 0.1, phn_drop: float = 0.1,
                 freeze_feature_encoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.tv_drop = tv_drop
        self.phn_drop = phn_drop
        self.wav2vec2 = Wav2Vec2Model(
            cfg, freeze_feature_encoder=freeze_feature_encoder)
        self.tv_linear = nn.Linear(cfg.hidden_size, NUM_TVS)
        self.phn_linear = nn.Linear(cfg.hidden_size, num_phonemes)
        taps = lowpass_fir_taps(lowpass_cutoff_hz, frame_rate_hz)
        self.register_buffer("fir_taps",
                             torch.tensor(taps, dtype=torch.float32),
                             persistent=False)

    def tv_head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.training and self.tv_drop:
            hidden = F.dropout(hidden, self.tv_drop)
        tv = self.tv_linear(torch.tanh(hidden).float())
        return fir_lowpass(tv, self.fir_taps)

    def phn_head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.training and self.phn_drop:
            hidden = F.dropout(hidden, self.phn_drop)
        return self.phn_linear(F.leaky_relu(hidden, 0.01).float())

    def forward(self, audio_inputs: torch.Tensor,
                audio_lengths: torch.Tensor, phn_frames: torch.Tensor,
                tv_targets: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The training forward: ``audio_inputs`` (B, L), ``audio_lengths``
        (B,) in samples, ``phn_frames`` (B, T) frame phoneme ids (pad 0),
        ``tv_targets`` (B, T, 9) in TV_ORDER (pad −100). Dropout and
        SpecAugment act in ``train()`` mode (SpecAugment's spans from
        ``generator``). Returns ``loss``, ``mse_loss``, ``ce_loss``,
        ``tvs_pred``, ``phn_fc_pred``, ``phn_logits`` and
        ``frame_lengths``."""
        hidden, frame_lengths, _ = self.wav2vec2(audio_inputs, audio_lengths,
                                                 generator=generator)
        return self._train_out(hidden, frame_lengths, phn_frames, tv_targets)

    def train_from_features(self, fe_features: torch.Tensor,
                            audio_lengths: torch.Tensor,
                            phn_frames: torch.Tensor,
                            tv_targets: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
        """``forward`` from the frozen feature extractor's cached output
        (B, T, conv_dim[-1]); ``audio_lengths`` stays in samples. Equal to
        ``forward`` on valid frames: SpecAugment and every dropout act
        after the projection."""
        hidden, frame_lengths, _ = self.wav2vec2(
            None, audio_lengths, precomputed_features=fe_features,
            generator=generator)
        return self._train_out(hidden, frame_lengths, phn_frames, tv_targets)

    def _train_out(self, hidden, frame_lengths, phn_frames, tv_targets):
        # the targets' static width against the encoder's frame count: the
        # extra frames are padding and carry the mask sentinels
        t = hidden.shape[1]
        tv_targets = _pad_or_trim(tv_targets.to(hidden.device).float(), t,
                                  TV_PAD_VALUE)
        phn_targets = _pad_or_trim(phn_frames.to(hidden.device).long(), t, 0)

        tvs = self.tv_head(hidden)
        logits = self.phn_head(hidden)

        tv_mask = (tv_targets != TV_PAD_VALUE).float()
        # means over the valid frames of the (global) batch
        mse = global_mean((tv_mask * (tvs - tv_targets) ** 2).sum(),
                          tv_mask.sum())
        phn_mask = (phn_targets != 0).float()
        nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                            phn_targets[:, :, None])[..., 0]
        ce = global_mean((phn_mask * nll).sum(), phn_mask.sum())
        return {
            "loss": 0.5 * mse + 0.5 * ce,
            "mse_loss": mse,
            "ce_loss": ce,
            "tvs_pred": tvs,
            "phn_fc_pred": logits.argmax(dim=-1).to(torch.int32),
            "phn_logits": logits,
            "frame_lengths": frame_lengths,
        }

    def predict(self, audio_inputs: torch.Tensor,
                audio_lengths: torch.Tensor,
                fields: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """Per-frame phoneme probabilities / logits / argmax and smoothed
        TV trajectories, with ``frame_lengths``. ``fields`` keeps only the
        named outputs (plus ``frame_lengths``) and skips a head whose
        outputs nobody asked for."""
        hidden, frame_lengths, _ = self.wav2vec2(audio_inputs, audio_lengths)
        want = set(PREDICT_FIELDS if fields is None else fields)
        out = {}
        if want & _PHN_FIELDS:
            logits = self.phn_head(hidden)
            probs = torch.softmax(logits, dim=-1)
            out["phn_fc_probs"] = probs
            out["phn_fc_logits"] = logits
            out["phn_fc_pred"] = probs.argmax(dim=-1).to(torch.int32)
        if "tvs_pred" in want:
            out["tvs_pred"] = self.tv_head(hidden)
        out["frame_lengths"] = frame_lengths
        return {k: v for k, v in out.items()
                if k in want or k == "frame_lengths"}


def random_aptai(cfg: Wav2Vec2Config, seed: int = 0,
                 num_phonemes: int = 46, **kwargs) -> APTAI:
    """An APTAI with random weights drawn from ``seed`` (CPU generator, so
    the same seed gives the same weights on any machine); ``kwargs`` go to
    :class:`APTAI`."""
    model = APTAI(cfg, num_phonemes=num_phonemes, **kwargs)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model
