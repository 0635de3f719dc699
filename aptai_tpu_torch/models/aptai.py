"""APTAI: tract-variable regression + frame-level phoneme classification on
the wav2vec2 encoder, inference path.

  * TV head: Tanh (in the compute dtype) → float32 → Linear(hidden → 9),
    then the windowed-sinc low-pass (cutoff 10 Hz at the 49 Hz frame
    rate) over the whole padded frame axis;
  * phoneme head: LeakyReLU(0.01) (in the compute dtype) → float32 →
    Linear(hidden → num_phonemes).

Both heads' Linear layers stay float32 whatever ``cfg.dtype`` is. The
training loss waits for the training path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch import FRAME_RATE_HZ
from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model, init_weights_
from aptai_tpu_torch.ops.fir import fir_lowpass, lowpass_fir_taps

NUM_TVS = 9

PREDICT_FIELDS = ("phn_fc_probs", "phn_fc_logits", "phn_fc_pred",
                  "tvs_pred", "frame_lengths")
_PHN_FIELDS = frozenset(PREDICT_FIELDS[:3])


class APTAI(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, num_phonemes: int = 46,
                 lowpass_cutoff_hz: float = 10.0,
                 frame_rate_hz: float = float(FRAME_RATE_HZ)):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg)
        self.tv_linear = nn.Linear(cfg.hidden_size, NUM_TVS)
        self.phn_linear = nn.Linear(cfg.hidden_size, num_phonemes)
        taps = lowpass_fir_taps(lowpass_cutoff_hz, frame_rate_hz)
        self.register_buffer("fir_taps",
                             torch.tensor(taps, dtype=torch.float32),
                             persistent=False)

    def tv_head(self, hidden: torch.Tensor) -> torch.Tensor:
        tv = self.tv_linear(torch.tanh(hidden).float())
        return fir_lowpass(tv, self.fir_taps)

    def phn_head(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.phn_linear(F.leaky_relu(hidden, 0.01).float())

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
                 num_phonemes: int = 46) -> APTAI:
    """An APTAI with random weights drawn from ``seed`` (CPU generator, so
    the same seed gives the same weights on any machine)."""
    model = APTAI(cfg, num_phonemes=num_phonemes)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model
