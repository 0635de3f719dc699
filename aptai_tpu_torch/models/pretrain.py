"""Self-supervised wav2vec2 pretraining: the masked-contrastive objective of
the JAX package's ``models/pretrain.py`` over the shared encoder.

  audio (B, L) → :class:`Wav2Vec2Model` with an external span ``time_mask``
  (masked frames get the learned mask embedding) → hidden (B, T, hidden)
  and the conv features ``extract`` (B, T, C)
    → ``project_hid`` on float32 hidden → c (B, T, P)
    → float32 ``extract`` → feature dropout →
      :class:`GumbelVectorQuantizer` (G groups × V codevectors: Gumbel
      noise at temperature τ and a straight-through hard sample in
      ``train()``, the hard argmax in ``eval()``) → ``project_q`` → q
      (B, T, P)
    → per frame, q itself and K distractors drawn uniformly from the other
      valid frames of its utterance (:func:`sample_negative_indices`) →
      cosine logits / κ, the positive first, a distractor equal to the
      positive at −∞ → InfoNCE, averaged over the masked valid frames
    + ``diversity_weight`` · (GV − perplexity) / GV
    + ``feature_penalty_weight`` · mean of the squared conv features (pad
      frames zeroed, the mean over all B·T·C entries).

Parameter names are HF ``Wav2Vec2ForPreTraining``'s: the encoder under
``wav2vec2.`` (what ``train/builders.py`` grafts into the downstream
models), ``quantizer.codevectors`` (1, G·V, d/G), ``quantizer.weight_proj``,
``project_hid`` and ``project_q``. The head and the quantizer compute in
float32 whatever the encoder's dtype.

Random draws come from the ``generator`` given to ``forward`` (the train
step's), or are given as tensors (``gumbel_noise``, ``negative_indices``),
which is how the tests and the card check hold the port to the JAX module
on the same draws: torch cannot reproduce flax's random streams.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model, init_weights_


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel draws, float32: ``-log(-log(u))`` with ``u`` uniform
    in [tiny, 1), as ``jax.random.gumbel`` makes them."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


class GumbelVectorQuantizer(nn.Module):
    """Product quantizer with the Gumbel-softmax straight-through estimator
    (HF ``Wav2Vec2GumbelVectorQuantizer`` names)."""

    def __init__(self, in_dim: int, num_groups: int = 2,
                 num_vars: int = 320, codevector_dim: int = 256):
        super().__init__()
        if codevector_dim % num_groups:
            raise ValueError(f"codevector_dim {codevector_dim} is not a "
                             f"multiple of num_groups {num_groups}")
        self.num_groups, self.num_vars = num_groups, num_vars
        self.codevectors = nn.Parameter(torch.rand(
            1, num_groups * num_vars, codevector_dim // num_groups))
        self.weight_proj = nn.Linear(in_dim, num_groups * num_vars)

    def forward(self, x: torch.Tensor, temperature,
                pos_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """``x`` (B, T, C) → ``(quantized (B, T, codevector_dim),
        perplexity)``. ``pos_mask`` (B, T) selects the positions the
        codebook-usage perplexity averages over (all when None). In
        ``train()`` the Gumbel ``noise`` (B, T, G, V) is drawn from
        ``generator`` unless given."""
        b, t, _ = x.shape
        g, v = self.num_groups, self.num_vars
        logits = self.weight_proj(x.float()).view(b, t, g, v)
        if self.training:
            if noise is None:
                noise = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits + noise.to(logits.device))
                                   / temperature, dim=-1)
            hard = F.one_hot(y_soft.argmax(-1), v).to(y_soft.dtype)
            # straight-through: the hard sample forward, the soft backward
            probs = hard + y_soft - y_soft.detach()
        else:
            probs = F.one_hot(logits.argmax(-1), v).float()

        # codebook usage from the noise-free softmax over the selected
        # positions, a perplexity per group, summed
        marg = torch.softmax(logits, dim=-1)
        if pos_mask is not None:
            w = pos_mask.to(marg.device, torch.float32)[:, :, None, None]
            mean_probs = (marg * w).sum((0, 1)) / w.sum().clamp(min=1.0)
        else:
            mean_probs = marg.mean((0, 1))
        perplexity = torch.exp(-(mean_probs * torch.log(mean_probs + 1e-7))
                               .sum(-1)).sum()

        cv = self.codevectors.view(g, v, -1)
        quantized = torch.einsum("btgv,gvd->btgd", probs, cv)
        return quantized.reshape(b, t, -1), perplexity


def negative_indices_from_uniform(u: torch.Tensor,
                                  frame_lengths: torch.Tensor
                                  ) -> torch.Tensor:
    """(B, T, K) distractor frame indices from uniforms ``u`` (B, T, K) in
    [0, 1): ``u · (L − 1)`` in float32, truncated, shifted past the frame
    itself, and clamped to ``L − 1``, with ``L = max(frame_length, 2)`` —
    the JAX package's construction, so the same uniforms give the same
    indices."""
    t = u.shape[1]
    lengths = frame_lengths.to(u.device, torch.int32).clamp(
        min=2)[:, None, None]
    idx = (u.float() * (lengths - 1).float()).to(torch.int32)  # [0, L-2]
    pos = torch.arange(t, dtype=torch.int32, device=u.device)[None, :, None]
    idx = idx + (idx >= pos).to(torch.int32)  # skip the frame itself
    return torch.minimum(idx, lengths - 1)


def sample_negative_indices(generator: Optional[torch.Generator], b: int,
                            t: int, frame_lengths: torch.Tensor,
                            num_negatives: int) -> torch.Tensor:
    """(B, T, K) distractor indices: uniform over the valid frames of the
    same utterance other than the frame itself, the uniforms drawn from
    ``generator`` on ``frame_lengths``' device."""
    u = torch.rand((b, t, num_negatives), generator=generator,
                   device=frame_lengths.device)
    return negative_indices_from_uniform(u, frame_lengths)


class Wav2Vec2Pretrain(nn.Module):
    """The masked-contrastive pretraining head over the shared encoder (the
    feature extractor trainable). Dropout and the Gumbel noise act in
    ``train()`` mode; ``eval()`` quantizes by the hard argmax."""

    def __init__(self, cfg: Wav2Vec2Config, num_groups: int = 2,
                 num_vars: int = 320, codevector_dim: int = 256,
                 proj_codevector_dim: int = 256, num_negatives: int = 100,
                 contrastive_temperature: float = 0.1,
                 diversity_weight: float = 0.1,
                 feature_penalty_weight: float = 10.0):
        super().__init__()
        if not cfg.apply_spec_augment:
            raise ValueError("pretraining needs cfg.apply_spec_augment "
                             "(the learned mask embedding)")
        self.cfg = cfg
        self.num_negatives = num_negatives
        self.contrastive_temperature = contrastive_temperature
        self.diversity_weight = diversity_weight
        self.feature_penalty_weight = feature_penalty_weight
        self.wav2vec2 = Wav2Vec2Model(cfg)
        self.quantizer = GumbelVectorQuantizer(
            cfg.conv_dim[-1], num_groups, num_vars, codevector_dim)
        self.project_hid = nn.Linear(cfg.hidden_size, proj_codevector_dim)
        self.project_q = nn.Linear(codevector_dim, proj_codevector_dim)

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor, time_mask: torch.Tensor,
                gumbel_temperature=2.0,
                generator: Optional[torch.Generator] = None,
                gumbel_noise: Optional[torch.Tensor] = None,
                negative_indices: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``input_values`` (B, L), ``input_lengths`` (B,) in samples,
        ``time_mask`` (B, T_frames) bool, True = masked. Returns ``loss``
        and its terms ``contrastive_loss``, ``diversity_loss`` and
        ``feature_penalty``, ``codebook_perplexity``,
        ``contrastive_accuracy``, ``num_masked`` and ``frame_lengths``.
        The encoder's SpecAugment channel spans (if any), the Gumbel noise
        and the distractor indices draw from ``generator`` unless
        ``gumbel_noise`` (B, T, G, V) and ``negative_indices`` (B, T, K)
        are given."""
        hidden, frame_lengths, extract = self.wav2vec2(
            input_values, input_lengths, time_mask=time_mask,
            generator=generator)
        b, t, _ = hidden.shape
        dev = hidden.device
        valid = torch.arange(t, device=dev)[None, :] < frame_lengths[:, None]
        mask = time_mask[:, :t].to(dev) & valid

        c = self.project_hid(hidden.float())  # (B, T, P)
        extract = extract.float()
        rate = self.cfg.feat_proj_dropout
        feats = (F.dropout(extract, rate) if self.training and rate
                 else extract)
        quantized, perplexity = self.quantizer(
            feats, gumbel_temperature,
            pos_mask=mask if self.training else valid, generator=generator,
            noise=gumbel_noise)
        q = self.project_q(quantized)  # (B, T, P)

        if negative_indices is None:
            negative_indices = sample_negative_indices(
                generator, b, t, frame_lengths, self.num_negatives)
        # candidates: the positive (the frame itself) first, then the
        # distractors, gathered from q and from its normalised copy (the
        # raw rows only decide collisions and carry no gradient)
        cand_idx = torch.cat([
            torch.arange(t, device=dev)[None, :, None].expand(b, t, 1),
            negative_indices.to(dev, torch.long)], dim=2)  # (B, T, 1+K)
        rows = torch.arange(b, device=dev)[:, None, None]
        c_n = c / c.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        q_n = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        cand = q.detach()[rows, cand_idx]  # (B, T, 1+K, P)
        cand_n = q_n[rows, cand_idx]
        logits = torch.einsum("btp,btkp->btk", c_n, cand_n)
        logits = logits / self.contrastive_temperature

        # a distractor with the positive's exact codevector is no negative
        # (HF's neg_is_pos; jnp.isclose's tolerances)
        neg_is_pos = torch.isclose(cand[:, :, 1:], cand[:, :, :1],
                                   rtol=1e-5, atol=1e-8).all(-1)
        logits = torch.cat([logits[:, :, :1], logits[:, :, 1:].masked_fill(
            neg_is_pos, float("-inf"))], dim=2)

        logp = torch.log_softmax(logits, dim=-1)[:, :, 0]  # (B, T)
        n_masked = mask.sum()
        denom = n_masked.clamp(min=1)
        contrastive = -torch.where(mask, logp, 0.0).sum() / denom

        gv = self.quantizer.num_groups * self.quantizer.num_vars
        diversity = (gv - perplexity) / gv
        feat_pen = torch.where(valid[:, :, None], extract, 0.0).pow(2).mean()
        loss = (contrastive + self.diversity_weight * diversity
                + self.feature_penalty_weight * feat_pen)
        # masked-frame top-1 accuracy (argmax takes the first index)
        acc = (mask & (logits.argmax(-1) == 0)).sum() / denom
        return {
            "loss": loss,
            "contrastive_loss": contrastive,
            "diversity_loss": diversity,
            "feature_penalty": feat_pen,
            "codebook_perplexity": perplexity,
            "contrastive_accuracy": acc,
            "num_masked": n_masked,
            "frame_lengths": frame_lengths,
        }


def random_wav2vec2_pretrain(cfg: Wav2Vec2Config, seed: int = 0,
                             **kwargs) -> Wav2Vec2Pretrain:
    """A :class:`Wav2Vec2Pretrain` with random weights from ``seed`` (CPU
    generator) in the JAX module's distributions: the encoder and the
    projections as :func:`init_weights_` draws them, the codevectors
    uniform in [0, 1), ``weight_proj``'s weight standard normal and its
    bias zero. ``kwargs`` go to :class:`Wav2Vec2Pretrain`."""
    model = Wav2Vec2Pretrain(cfg, **kwargs)
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    quantizer = model.quantizer
    with torch.no_grad():
        quantizer.codevectors.copy_(torch.rand(
            quantizer.codevectors.shape, generator=gen))
        quantizer.weight_proj.weight.copy_(torch.randn(
            quantizer.weight_proj.weight.shape, generator=gen))
    return model
