#!/usr/bin/env python3
"""Drive the PyTorch port (``aptai_tpu_torch``) on one NVIDIA GPU, end to end.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds every kernel from ``csrc/``, one process per source, all
   started together.
2. Kernels against their plain versions on the card: the flash forward (and
   its logsumexp) at the serving shape (bf16, B=32, H=16, T=499, D=64) and
   the forward, dq and dk/dv kernels at the training shape (B=8, H=16,
   T=249), with ragged lengths including 0 and 1, T=1100 for several tiles
   (ragged, lengths 0 and 1), the edges of the 64- and 128-row and key
   tiles (T 65, 128, 129 and 257, lengths on either side of each edge), and
   the
   float32 variants; the Δ the dq kernel writes against
   ``attention_delta``, and a relaunch of the forward and of both backward
   kernels on the same inputs bit for bit; the fused conv + LayerNorm +
   GELU at the shapes of feature-extractor layers 1 and 6 of a 32 x 10 s
   batch, at the edges of its 128-row tile and of two tiles (T_out 127,
   128, 129, 255, 256, 257), with an item ending mid-tile, T_out = 1, C_out
   128 and 256, strides 1 and 4, with and without bias, x followed by NaN
   in its buffer (nothing past x may be read), a relaunch bit for bit, and
   its float32 variant; then each kernel's time beside
   its bound, its plain version's time and a PyTorch yardstick (one library
   call: SDPA's forward at both shapes, at the serving shape also without
   a mask, and its backward; for the fused conv the chain conv1d ->
   LayerNorm -> GELU, per fused layer, with each layer's TFLOP/s).
3. Serving: a small float32 model on the card against the same model on
   the CPU; then full-width wav2vec2-large APTAI in bf16 (weights from seed
   0) served by the ``MicroBatcher`` on its background thread, 8 requests of
   1-10 s, with the kernel launch counts read around that run; then the
   same batch with attention forced to the plain version, which must agree.
3b. W2V2PR serving: a small float32 W2V2PR with the fused feature extractor
   on the card against the CPU (logits, CTC loss, greedy sequences); then
   full-width bf16 W2V2PR (vocab 46, ``fused_feature_extractor=True``, seed
   0) behind the ``MicroBatcher``, 8 requests of 1-10 s, 6 fused and 24
   flash-forward launches per batch; the same batch with the fused layers
   forced to the plain version, which must agree; ``get_embeddings`` and
   ``predict_phonemes_durations`` on two items.
4. Serving throughput: ``predict_batch`` at 32 x 10 s, audio-s/s and MFU,
   and a profiler breakdown of one batch by kernel.
4b. W2V2PR ``encode_batch`` at 32 x 10 s (audio-s/s, MFU, a profile); APTAI
   ``predict_batch`` at 32 x 10 s with the fused feature extractor off and
   on, alternated off, on, on, off, and each one's feature extractor alone
   under the profiler. Records, not claims.
5. Training: a small float32 model's train step on the card against the
   CPU; then the full-width bf16 APTAI train step (float32 masters, seed 0)
   at 8 x 5 s with dropout and SpecAugment on and the feature encoder
   frozen, with the kernel launch counts of one step, train audio-s/s, MFU,
   peak memory and a profile; the same batch without dropout through the
   kernels and through plain attention, whose gradients must agree; one
   step with ``remat_policy="full"``; one step with the fused feature
   extractor (6 fused launches, a finite loss); and W2V2PR with a trainable
   encoder and the flag on, which must refuse to run.
5b. W2V2PR training through ``TrainStep(..., pr_loss_fn())``: a small
   float32 W2V2PR's two Adam steps on the card against the CPU; then
   full-width bf16 W2V2PR (seed 0) with its feature encoder trainable, at 8
   x 5 s with 40-70 labels an item, dropout and SpecAugment on: the first
   step's launches (24 of each flash kernel, no fused conv, Δ in the dq
   kernel), train audio-s/s, MFU, peak memory and a profile, the CTC loss
   and the feature encoder's backward each timed alone, every trainable
   tensor moved; ``validate_pr`` through ``make_eval_forward`` over two
   batches with the C++ beam (every item through it) and greedily; the
   gradients of every encoder tensor through the kernels against plain
   attention; one step each with ``remat_policy="dots"`` and ``"full"``
   (48 forward launches, the same loss); and one step with the encoder
   frozen and the fused flag on (6 fused launches, the encoder
   bit-identical), then a step from that encoder's output
   (``train_from_features``) against one from the audio.

6. FORCE-APTAI serving: a small float32 ForceAPTAI on the card against the
   CPU (``predict`` and ``get_alignment``); full-width FORCE-APTAI (bf16
   wav2vec2-large W2V2PR tower, float32 head, seed 0) behind the
   ``MicroBatcher``, 8 requests of 1-10 s, greedy, 24 flash-forward and no
   other launches per batch; the same batch's tower through plain
   attention with the same decoded sequences (per-TV Pearson, alignment
   argmax) and its sequences held to the noise floor; ``beam_host``
   through the split path on 6 requests in a batch of 8 (the C++ beam for
   the 6 real rows only); one batch with the fused feature extractor (6
   fused + 24 forward); ``predict_batch`` at 32 x 10 s (audio-s/s, MFU of
   the tower's FLOPs, a profile).
6b. The FORCE head train step at 8 x 5 s (frozen tower, head dropout on):
   a small float32 model's two Adam steps on the card against the CPU;
   then full width, one step from audio (24 flash-forward launches, no
   backward ones, Adam state for the head only), steps from audio and from
   the frozen-tower cache (``encode_items`` → ``collate_encoded`` →
   ``force_loss_fn(from_encoded=True)``), each with step ms, device idle
   and peak memory; ForwardSum alone timed; the tower bit-identical and
   every head tensor moved; ``make_eval_forward`` with ``ctc_seq_per`` and
   ``validate_tv`` over two batches.
7. The data layer and the device beam, in a temporary directory: the
   device beam (with times; CTC-like, uniform and pairwise-tied
   posteriors), ``viterbi_align`` and the signal ops on the card against
   the CPU (the beam and the alignment exact, and the beam against the
   C++ beam on the CTC-like case; the signal ops within 1e-4); a
   synthetic HPRC corpus made on the card (4 speakers x 2 texts x 2
   rates) → ``HPRCDataset`` → ``loso_split`` → ``BucketedLoader(
   collate_tv)`` read through ``PrefetchLoader``; full-width bf16 APTAI
   with a frozen fused feature extractor through ``FECachedLoader`` (6
   fused launches a batch, its bytes and ms), three steps from the cache
   (24 launches of each flash kernel a step, finite losses) and one
   batch's step from the cache against its step from audio; full-width
   FORCE-APTAI with ``decode_method="beam_device"`` through
   ``FrozenEncodedLoader`` and ``FrozenEncodedCorpus.loader_for`` (24
   forward launches a batch), two head steps; ``predict_batch`` at 32 x
   10 s with the device beam beside greedy, the beam alone (wall ms,
   kernel launches) against the C++ beam over the same rows, their
   sequences equal or within the noise floor of a (1 + 2^-9) nudge;
   ``validate_pr`` with ``"beam_device"`` beside ``"beam"`` on the FORCE
   tower (full-width W2V2PR). The phase's seconds are printed.
8. The trainers at full width (bf16 compute, float32 masters, seed 0) on a
   synthetic CommonPhone and HPRC corpus in a temporary directory: (8a)
   ``train_pr.main`` through its argv (laptop, batch 4, 8 samples an
   epoch, the FE trainable, ``beam_device`` validation), its artifacts, 24
   launches of each flash kernel and no fused one in the epoch's step, and
   ``load_predictor(best)`` serving the logits of the model in memory bit
   for bit; (8b) ``train_force_aptai.run`` over 8a's run on two folds from
   the corpus cache (``pr_spliced``, the cache built once, head-only saves
   beside one ``frozen_tower.msgpack``, whole-model best and last after each
   fold, ``load_predictor(best)`` serving 8a's tower bit for bit), then one
   fold that the collapse guard (threshold 0, patience 1) switches to
   ``beam_host``; (8c) ``train_aptai.run`` on one fold over 2 epochs from
   the FE cache, preempted by SIGTERM during epoch 2 (``Preempted``, the
   resume checkpoint's meta), then resumed over the same directory (epoch 2
   again, the step counter, Adam state and parameters equal bit for bit
   to the files, read by this package's msgpack reader, and to the
   preempted run's own), the epoch's launches and step ms beside
   ``TrainStep`` alone on the same batches; (8d) ``eval_cli.main`` on 8c's
   best checkpoint for the held-out speaker against the fold's test dict
   (1e-4 relative). Checkpoint seconds and GB per run, peak memory per fold
   and the phase's seconds are printed; each run's directory is deleted
   once checked, but for 8c's and the first FORCE fold's best checkpoints.
9. The inference surfaces at full width, in phase 8's directory: (9a) the
   streamers of the three families (APTAI; W2V2PR with the fused feature
   extractor; FORCE greedy; random weights, seed 0) over 10 minutes of the
   synthetic corpora's audio in 4 × 20 s chunk groups with 2 s of
   overlap: wall s, audio-s/s, peak memory, the launches a group (24
   flash-forward, 6 fused under the flag), the stitched length of the whole
   recording, ``per_file``, ``upload_ahead`` and the int16 transfer bit for
   bit against the default, a 7.3 s recording streamed against
   ``predict_batch`` (per-TV Pearson ≥ 0.999, frame agreement ≥ 99 %), a
   small float32 APTAI streamed on the card against the CPU (1e-4), and
   the flash forward and the fused conv against their plain versions at
   the streamed shape (T = 999); (9b) ``build_app`` over 8c's checkpoint
   behind the native (C++ epoll) transport: 256 ``/v1/predict`` requests
   of 1-10 s, float32 and int16, from 16 client threads (requests/s,
   audio-s/s, latency p50/p95/p99, batches formed, the launches of one
   batch alone), each response held to ``ServingApp.handle`` on the same
   audio; 64 of them through the Python transport; a 2-minute
   ``/v1/stream`` in the binary format against the streamer; ``/healthz``
   and ``/metrics``; (9c) ``python -m aptai_tpu_torch.infer`` in two
   subprocesses started together: 8 wavs over 8c's checkpoint against
   ``predict_batch`` in the same batches, and ``--task alignment`` over
   the FORCE checkpoint.
10. wav2vec2 pretraining (``models/pretrain.py``, ``train/pretrain.py``):
   (10a) a small float32 ``Wav2Vec2Pretrain`` (G 2 x V 320, K 100) on the
   card against the CPU on given draws, in ``train()`` (Gumbel noise,
   straight-through) and in ``eval()`` with one frame's distractors all
   equal to its positive: the eight outputs within 1e-4 relative, the
   gradients within 1e-4; (10b) the full-width step (wav2vec2-large, bf16
   compute, float32 masters, G 2 x V 320, d = P = 256, K 100, seed 0)
   through ``TrainStep(..., pretrain_loss_fn())`` at 8 x 5 s with dropout
   and masking on: one step's launches (24 of each flash kernel, no fused
   conv, Δ in the dq kernel), the median step ms, train audio-s/s, MFU
   (the encoder's FLOPs x 3), peak memory and a profile; losses finite,
   the accuracy in [0, 1], the perplexity in (0, G·V]; the same batch in
   ``eval()`` on fixed draws through the kernels and through plain
   attention, the encoder gradients under phase 5's gates; (10c) the same
   at 4 x 15 s (T = 749, ragged); (10d) ``pretrain.main`` through its argv
   (full width, laptop, batch 4) on a synthetic CommonPhone corpus in a
   temporary directory (finite ``val_*``, the best checkpoint, 24
   launches of each flash kernel in the step), then ``build_pr_model``
   with ``pretrained_checkpoint`` at that run: every encoder tensor equal
   to the best checkpoint's bit for bit.
11. The kernels as ``torch.library`` ops and the serving export
   (``infer/export.py``), in phase 8's directory: (11a)
   ``torch.library.opcheck`` on every ``aptai_torch`` op with CUDA inputs
   (the flash forward with and without the logsumexp, dq, dk/dv and the
   fused conv in bf16 and float32; FORCE's packed BiLSTM and device beam),
   and the host time of one attention call through the op beside the
   kernel's wrapper alone;
   (11b) small float32 bundles exported on the card (FORCE greedy and
   ``beam_device``, W2V2PR with the fused feature extractor), each graph
   holding the kernel ops and no packing, each against the live predictor
   on the same requests, and one FORCE bundle for ``("cuda", "cpu")``
   loaded on the CPU, in a fresh process with CUDA hidden, against the CPU
   predictor; (11c)
   ``aptai-torch-export`` (``export.main``) over phase 8's APTAI and FORCE
   checkpoints at bf16, 16 x 10 s (export and load seconds, bytes), and a
   full-width W2V2PR bundle with the fused feature extractor: 16 requests
   of 1-10 s in one bundle batch against the live predictor under the
   serving gates of phases 3 and 6, each batch's launches (24 flash
   forward; 6 fused more for W2V2PR), and the APTAI and FORCE bundles'
   audio-s/s at 16 x 10 s beside the live predictor's, alternated live,
   bundle, bundle, live; (11d) ``build_app`` over the APTAI bundle behind
   the native transport: 8 ``/v1/predict`` requests against the live
   app's ``ServingApp.handle`` under phase 9b's gates, an 11 s request's
   400, ``/v1/stream`` without a streamer, ``/healthz`` naming the bundle
   and its platforms.
12. W8A8 int8 serving (``ops/quant.py``, ``Wav2Vec2Config.quant``), in
   phase 8's directory: (12a) each encoder GEMM at 32 x 10 s (M 15968; K,
   N of q/k/v/out and the FFN's two) and a padded 5-row one: the
   ``_int_mm`` product equal to the exact float64 one, the card's codes,
   scales and W8A8 products (both dequantization orders) bit for bit the
   CPU's, and the device times of the bf16 ``F.linear``, ``_int_mm``
   (with the weight codes as the transpose of (N, K) and as (K, N)
   row-major), the row quantize and the whole op, beside the bf16 and int8
   bounds; (12b) a small float32 W8A8 APTAI on the card against the CPU:
   the CPU given the card's codes and scales for each quantized layer's
   input under phase 3's gates (its own codes one step from the card's at
   most), and free under 12c's deviation gates, the codes that differ
   counted (a tie that rounds the other way moves every later
   activation);
   (12c) full-width bf16 APTAI (seed 0) at 32 x 10 s in the modes none,
   ``w8a8_ffn`` and ``w8a8`` (the same weights), alternated none, ffn,
   w8a8, w8a8, ffn, none (median of 5 each): audio-s/s, the TV RMS
   relative error (≤ 0.05) and frame-phoneme agreement (≥ 99 %) against
   exact bf16, 24 flash launches and the peak memory of one batch in each,
   a profile of one ``w8a8_ffn`` batch; W2V2PR with the fused feature
   extractor and FORCE greedy, one ``w8a8`` batch each against exact
   (FORCE's TVs under the same gate, its sequences counted); (12d)
   ``build_app(quant="w8a8_ffn")`` over phase 8's APTAI run behind the
   native transport: 8 requests against ``ServingApp.handle`` over
   ``load_predictor(quant="w8a8_ffn")``, byte for byte counted and under
   phase 9b's gates, the streamer on the same model.
13. The encoder's config variants (``fused_qkv``, ``attention_layout=
   "bthd"``, ``do_stable_layer_norm=False``): (13a) the flash forward, dq
   and dk/dv on q, k and v split from one bf16 (B, T, 3C) tensor (the
   views ``fused_qkv`` hands them, time stride 3C) at the serving (32 x
   499) and training (8 x 249) shapes, ragged, against their plain
   versions under phase 2's gates and bit for bit against the same
   kernels on contiguous copies, with the forward's time on each; (13b) a
   small float32 APTAI in all three variants on the card against the CPU;
   full-width bf16 APTAI (the weights of seed 0's default model, q, k and
   v concatenated for ``fused_qkv``) at 32 x 10 s in the default and each
   variant alone and together: audio-s/s, 24 flash launches a batch, the
   encoder output's dtype (float32 when non-stable), ``"bthd"`` bit for
   bit the default, ``fused_qkv`` within phase 3's serving gates of the
   default and all three within them of non-stable; (13c) one APTAI train
   step at 8 x 5 s in ``fused_qkv`` + non-stable (24 / 24 / 24 launches, a
   finite loss, step ms), its encoder gradients through the kernels
   against plain attention under phase 5's gates; (13d) one ``w8a8``
   batch in ``"bthd"`` and one in ``fused_qkv``: the FFN's two Linears a
   layer quantized and no projection, 12c's deviation gates against the
   exact default.

14. The HPRC preparation (``data/hprc_prep.py``), in a temporary
   directory: a raw ``.mat`` release of all eight speakers (2 texts x N / F
   x R01 / R02, 2-4 s at 44.1 kHz, F02 without ML, EMA with NaN dropouts,
   a palate each) with the MAUS TextGrids written in place of the
   alignment; ``python -m aptai_tpu_torch.data.hprc_prep --platform auto``
   as a child process (utterances/s, the seconds of each step), the same
   tree prepared on the host CPU in this process, the card's log-mel and
   MFCC within ``PREP_SPECTRAL_RTOL`` of the CPU's and every other file
   byte for byte (the manifests with their roots swapped); then
   ``train_aptai.run`` for one epoch of one LOSO fold from the prepared
   manifest at full width (8c's config), 24 launches of each flash kernel
   a step and no fused one, finite test metrics.
15. The checkpoint files (``train/checkpoints.py``), in a temporary
   directory, under deterministic cuDNN: full-width APTAI (bf16, 8 x 5 s,
   seed 0) takes 3 steps; ``CheckpointManager.update`` writes best and
   last as the JAX package's ``params.msgpack`` / ``opt_state.msgpack``
   (GB, GB/s, and the seconds of the bridge's layouts on the card, the
   device→host copy, the msgpack headers and the file writes; the fsync
   after), beside ``torch.save`` of the same state as the older ``.pt``
   files; the files read back: float32 leaves and an int32 count, params
   and Adam moments bit for bit the live ones, the frozen FE's moments
   zeros; then the next step twice from memory (the card's run-to-run
   floor) and ``fit`` resuming a model of other weights from the files
   for one step, bit for bit the step without the write (or, were the
   repeat not bit for bit, within ten times its difference); 24 launches
   of each flash kernel a step.
16. The data axis (``parallel/``) on one NCCL rank, cuDNN deterministic:
   ``init_distributed`` on a free local port and ``make_mesh``; full-width
   APTAI (bf16, 8 x 5 s, seed 0, dropout and SpecAugment on) takes two
   steps plain, two under DDP (``shard_tree``) and two under FSDP
   (``shard_tree(fsdp=True)``): 24 launches of each flash kernel a step
   under each, DDP's losses and parameters against the plain step's (bit
   for bit or by how much), both wrappers' trained models served within
   phase 3's gates of the plain one, the per-rank bytes of parameters and
   Adam state; three rounds of one timed step each (``StepTimer``), the
   wrappers alternated, then two steps of each inside ``trace_profile``,
   whose one trace file must name the flash forward kernel, and one
   profiled step of each (kernel time against wall time, top kernels); ``fetch_pytree`` of the parameters and Adam state bit for bit
   ``.cpu()`` leaf by leaf, GB/s of both; ``device_peak_int8_tops()`` and
   phase 12a's int8 bounds from it; the group destroyed.

Output: the phases' lines, then one JSON line of kernel records, the card
line, and last ``{"ok": true, "device": {...}}``. A flash kernel record's
``launches`` is its count over one train step of phase 5, the fused conv's
its count over the W2V2PR batches of phase 3b; ``launches_by_path`` holds
each path's own count (APTAI serving, W2V2PR serving, the APTAI train step,
the APTAI train step with the fused feature extractor, the W2V2PR train
step, the W2V2PR train step with a frozen fused feature extractor, FORCE
serving, FORCE serving with the fused feature extractor, the FORCE train
step from audio, the FE cache pass, the APTAI step from the FE cache, the
FORCE cache pass with the device beam, the APTAI trainer's epoch from
the FE cache, the three streams of 9a, one batch served over HTTP in 9b,
the pretraining step at 8 x 5 s and at 4 x 15 s, the pretraining
trainer's epoch, one batch of each bundle of 11c, one request to the
bundle app of 11d, one APTAI batch in ``w8a8_ffn`` and in ``w8a8``, one
W2V2PR and one FORCE batch in ``w8a8``, one request to the
``w8a8_ffn`` app of 12d, one APTAI batch in each encoder variant of 13b,
the train step of 13c, the two ``w8a8`` batches of 13d, the APTAI
epoch of 14 from the prepared manifest, the six APTAI steps of 15, and
the two DDP and two FSDP steps of 16), each read with the counts set to
0 just before it.

Phase 13 alone, from the repository root (the kernels build at first
use; ``main`` also turns TF32 off, which the small float32 models' gates
need):

    python3 -c "import torch, chip_smoke as cs; \
    torch.backends.cudnn.allow_tf32 = False; \
    cs.phase_variants(cs.card_line())"

Phase 14 alone, in a temporary directory:

    python3 -c "import pathlib, tempfile, torch, chip_smoke as cs; \
    torch.backends.cudnn.allow_tf32 = False; \
    cs.phase_hprc_prep(cs.card_line(), pathlib.Path(tempfile.mkdtemp()))"

Phase 15 alone the same way: ``cs.phase_checkpoint(cs.card_line(),
pathlib.Path(tempfile.mkdtemp()))``; phase 16 as
``cs.phase_data_parallel(cs.card_line())``. The other phases' functions
run alone the same way.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import http.client
import io
import json
import mmap
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from signal import SIGTERM

import numpy as np
import torch

from aptai_tpu_torch.data import (BucketedLoader, HPRCDataset, PrefetchLoader,
                                  build_vocab, collate_tv,
                                  make_synthetic_commonphone,
                                  make_synthetic_hprc)
from aptai_tpu_torch.data.hprc_prep import prepare_hprc
from aptai_tpu_torch.data.synthetic import make_synthetic_hprc_raw
from aptai_tpu_torch.data.hprc import HPRC_SPEAKERS, loso_split
from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.data.audio_io import save_wav
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.data.synthetic import _random_utterance
from aptai_tpu_torch.decode import native
from aptai_tpu_torch.decode.beam import beam_decode_padded
from aptai_tpu_torch.decode.device import beam_decode_device
from aptai_tpu_torch.infer import (APTAIPredictor, ForceAPTAIPredictor,
                                   MicroBatcher, StreamingAPTAI,
                                   StreamingForceAPTAI, StreamingW2V2PR,
                                   W2V2PRPredictor, build_app, make_server)
from aptai_tpu_torch.infer.api import _prepare, fetch_outputs, quantize_i16
from aptai_tpu_torch.infer.native_transport import make_native_server
from aptai_tpu_torch.infer.serve import decode_binary, decode_wire_audio
from aptai_tpu_torch.infer.loader import load_model, load_predictor
from aptai_tpu_torch.models import (APTAI, W2V2PR, ForceAPTAI, Wav2Vec2Config,
                                    random_aptai, random_force_aptai,
                                    random_w2v2_pr, tiny_config)
from aptai_tpu_torch.models import w2v2_pr
from aptai_tpu_torch.models import wav2vec2 as w2v
from aptai_tpu_torch.models.convert import fuse_qkv_state_dict
from aptai_tpu_torch.models.pretrain import (negative_indices_from_uniform,
                                             random_wav2vec2_pretrain,
                                             sample_negative_indices)
from aptai_tpu_torch.ops import attention, fused_conv, kernels, quant, signal
from aptai_tpu_torch.ops.align import viterbi_align
from aptai_tpu_torch.ops.ctc import ctc_loss, greedy_decode
from aptai_tpu_torch.ops.forward_sum import forward_sum_loss
from aptai_tpu_torch.train import (APTAIConfig, FECachedLoader,
                                   ForceAPTAIConfig, FrozenEncodedCorpus,
                                   FrozenEncodedLoader, Preempted, TrainStep,
                                   aptai_loss_fn, build_aptai_model,
                                   collate_encoded, encode_items,
                                   epoch_learning_rate, fit, force_loss_fn,
                                   make_engine, pr_loss_fn, torch_adam)
from aptai_tpu_torch.train import (PRConfig, build_pr_model, eval_cli,
                                   pretrain, train_aptai, train_force_aptai,
                                   train_pr)
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               JaxAdamState, jax_adam_state,
                                               load_flax_params,
                                               msgpack_restore, read_params,
                                               save_state, to_host)
from aptai_tpu_torch.train.fe_cache import collate_fe
from aptai_tpu_torch.train.evaluate import validate_pr, validate_tv
from aptai_tpu_torch.train.train_force_aptai import ctc_seq_per
from aptai_tpu_torch.train.train_force_aptai import \
    make_eval_forward as force_eval_forward
from aptai_tpu_torch.train.train_pr import make_eval_forward
from aptai_tpu_torch.parallel import init_distributed, make_mesh, shard_tree
from aptai_tpu_torch.parallel.mesh import full_state_dict
from aptai_tpu_torch.utils.flops import (aptai_forward_flops,
                                         device_peak_int8_tops,
                                         device_peak_tflops, encoder_flops,
                                         mfu, pr_forward_flops,
                                         training_step_flops)
from aptai_tpu_torch.utils.profiling import StepTimer, trace_profile
from aptai_tpu_torch.utils.trees import fetch_pytree, tree_bytes

# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core peak, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SAMPLE_RATE = 16_000
# forward output: bf16 rounding of p before p.v, on unit-scale inputs
BF16_TOL = 2e-2
# backward outputs, relative to their largest magnitude: bf16 rounding of p
# and ds before their products and of the outputs; a rounding boundary
# falls differently when exp differs in its last bit
BF16_BWD_REL_TOL = 2e-2
F32_TOL = 1e-4  # float32 variants: summation order and exp/log ulps
# the dq kernel's Δ = rowsum(dO ⊙ O) against attention_delta, relative to
# its largest magnitude: f32 sums of the same 64 products in other orders
DELTA_REL_TOL = 1e-5
# the fused conv in bf16: the kernel and the plain version sum the conv's
# 1536 products in other orders, so a bf16 rounding boundary may fall on
# either side (one ulp); and where LayerNorm's acc − mean cancels to
# |y| ~ 1e-4, the ~1e-6 absolute f32 summation error is many ulps of the
# tiny output (both sit that far from a float64 reference there)
FUSED_BF16_ATOL = 1e-5
LSE_TOL = 1e-3  # logsumexp of unit-scale scores, f32 in both versions
NO_DROP = dict(hidden_dropout=0.0, activation_dropout=0.0,
               attention_dropout=0.0, feat_proj_dropout=0.0)
COUNTED = {
    "flash_attn_fwd": attention.flash_attention_bhtd_cuda,
    "flash_attn_bwd_dq": attention.flash_attention_bwd_dq_cuda,
    "flash_attn_bwd_dkv": attention.flash_attention_bwd_dkv_cuda,
    "fused_conv_ln_gelu": fused_conv.fused_conv_ln_gelu_cuda,
}
FLASH = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# wav2vec2-large's feature extractor at 32 x 10 s: layer 0's output length,
# then layers 1-6 (kernel, stride 2, C 512), the fused layers
FE_LENGTH0 = 31999
FE_KERNELS = (3, 3, 3, 3, 2, 2)


def fe_input_lengths():
    """The input length of each fused layer at 32 x 10 s."""
    lengths = [FE_LENGTH0]
    for k in FE_KERNELS[:-1]:
        lengths.append((lengths[-1] - k) // 2 + 1)
    return lengths


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, name_part: str = "") -> float:
    """Device time per call of ``fn``: the profiler's sum over the CUDA
    kernels whose name contains ``name_part`` (all kernels by default),
    over ``iters`` calls. Unlike :func:`cuda_ms` it leaves out the gaps in
    which the card waits for the host to launch, which decide the time of
    a launch that takes a few tens of microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and name_part in e.key)
    if total_us <= 0:
        raise AssertionError(f"the profiler saw no kernel {name_part!r}")
    return total_us / iters / 1e3


def reset_counts():
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2 ------------------------------------------------------------------

def _qkv(gen, b, h, t, dtype, model_layout, n=3):
    """Unit-scale (B, H, T, 64) tensors. ``model_layout``: (B, T, H, D)
    buffers viewed as (B, H, T, D), as the encoder's projections (and the
    gradient of the output projection) hand them over."""
    shape = (b, t, h, 64) if model_layout else (b, h, t, 64)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
          for _ in range(n)]
    return [x.transpose(1, 2) if model_layout else x for x in xs]


def _rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_kernel_case(name, q, k, v, dout, lengths, backward=True):
    """The forward (output and logsumexp) and, with ``backward``, the dq
    and dk/dv kernels against their plain versions on the same inputs.
    Returns the max abs errors {kernel: err}."""
    bf16 = q.dtype == torch.bfloat16
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                   return_lse=True)
    again, again_lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                           return_lse=True)
    torch.cuda.synchronize()
    # one block per query tile, no atomics: bit-identical on a relaunch
    fwd_same = torch.equal(got, again) and torch.equal(lse, again_lse)
    del again, again_lse
    want, want_lse = attention.flash_attention_bhtd_plain(
        q, k, v, lens, return_lse=True)
    errs = {"flash_attn_fwd": _rel_err(got, want)[0]}
    lse_err = (lse - want_lse).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    ok = (errs["flash_attn_fwd"] <= (BF16_TOL if bf16 else F32_TOL)
          and lse_err <= LSE_TOL and fwd_same
          and torch.equal(torch.isinf(lse), torch.isinf(want_lse))
          and torch.isfinite(got.float()).all().item())
    outs = [got]
    rel = {}
    extra = ""
    if backward:
        def run_backward():
            dq, delta = attention.flash_attention_bwd_dq_cuda(
                q, k, v, got, lse, dout, lens)
            dk, dv = attention.flash_attention_bwd_dkv_cuda(
                q, k, v, dout, lse, delta, lens)
            return dq, dk, dv, delta

        dq, dk, dv, delta = run_backward()
        again = run_backward()
        torch.cuda.synchronize()
        # no atomics, one order of every sum: bit-identical on a relaunch
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv, delta),
                                                     again))
        del again
        # each kernel against its plain version on the same inputs: the dk/dv
        # kernel's plain version gets the Δ the dq kernel wrote
        pq, want_delta = attention.flash_attention_bwd_dq_plain(
            q, k, v, got, lse, dout, lens)
        pk, pv = attention.flash_attention_bwd_dkv_plain(
            q, k, v, dout, lse, delta, lens)
        delta_rel = _rel_err(delta, want_delta)[1]
        tol = BF16_BWD_REL_TOL if bf16 else F32_TOL
        for kname, pairs in (("flash_attn_bwd_dq", ((dq, pq),)),
                             ("flash_attn_bwd_dkv", ((dk, pk), (dv, pv)))):
            pair_errs = [_rel_err(g, w) for g, w in pairs]
            errs[kname] = max(e for e, _ in pair_errs)
            rel[kname] = max(r for _, r in pair_errs)
            ok = ok and rel[kname] <= tol
        outs += [dq, dk, dv]
        ok = (ok and same and delta_rel <= DELTA_REL_TOL
              and all(torch.isfinite(x.float()).all().item() for x in outs))
        extra = (f", delta rel {delta_rel:.3e}; backward relaunch "
                 f"bit-identical {same}")
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    zero_ok = all(bool((x[i] == 0).all()) for x in outs for i in zero_rows)
    log(f"  {name}: shape {tuple(q.shape)} {q.dtype} lengths "
        f"{sorted(set(lengths))[:6]}... fwd max_abs_err "
        f"{errs['flash_attn_fwd']:.3e}, lse {lse_err:.3e}, forward relaunch "
        f"bit-identical {fwd_same}"
        + "".join(f", {n[15:]} max_abs_err {errs[n]:.3e} (rel {rel[n]:.3e})"
                  for n in rel)
        + f"{extra}; zero-length rows exactly 0: {zero_ok}")
    if not (ok and zero_ok):
        raise AssertionError(f"a flash kernel disagrees with its plain "
                             f"version: {name}")
    return errs


def time_forward(gen):
    """The forward at the serving path's data: 32 x 10 s, every frame
    valid. The kernel's device time from the profiler (``ms``) beside the
    wall time of back-to-back launches by CUDA events (``cuda_ms``, the
    figure recorded before device times); yardsticks by device time: SDPA
    with the same boolean
    mask (``library_ms``) and SDPA without a mask on the same dense batch
    (``sdpa_unmasked_ms``, PyTorch's flash backend, the tougher bar)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, t = 32, 16, 499
    q, k, v = _qkv(gen, b, h, t, torch.bfloat16, True)
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: attention.flash_attention_bhtd_cuda(q, k, v, full),
                   50, "flash_fwd_bf16")
    wall_ms = cuda_ms(lambda: attention.flash_attention_bhtd_cuda(
        q, k, v, full), 50)
    plain_ms = cuda_ms(
        lambda: attention.flash_attention_bhtd_plain(q, k, v, full), 10)
    mask = (torch.arange(t, device="cuda")[None, :] < full[:, None])
    mask = mask[:, None, None, :]
    library_ms = device_ms(lambda: sdpa(q, k, v, attn_mask=mask), 50)
    unmasked_ms = device_ms(lambda: sdpa(q, k, v), 50)
    n = sum(full.tolist())
    flops = 4 * h * 64 * t * n                  # q.k^T and p.v, valid keys
    nbytes = 2 * h * 64 * (2 * b * t + 2 * n)   # q, o; k, v to the length
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  flash_attn_fwd at B={b} H={h} T={t} D=64 bf16: {ms * 1e3:.1f} us "
        f"device ({wall_ms * 1e3:.1f} us a launch back to back) | plain "
        f"{plain_ms * 1e3:.1f} us | sdpa masked {library_ms * 1e3:.1f} us, "
        f"unmasked {unmasked_ms * 1e3:.1f} us (device) | bound "
        f"{bound_ms * 1e3:.1f} us ({bound_by}) | "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"ms": ms, "cuda_ms": wall_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_covers": "scaled_dot_product_attention with the same "
                              "boolean key mask, device time",
            "sdpa_unmasked_ms": unmasked_ms,
            "sdpa_unmasked_covers": "scaled_dot_product_attention without a "
                                    "mask on the same dense batch (every "
                                    "frame valid), device time"}


def time_training_kernels(gen, lengths):
    """The forward with its logsumexp and the two backward kernels at the
    training shape (B=8, H=16, T=249) with the training batch's
    ``lengths``; the SDPA forward, backward, and forward + backward on the
    same masked problem as yardsticks. Device times from the profiler;
    each launch's wall time (CUDA events over back-to-back calls, host
    launch gaps included) beside them. Returns the backward kernels'
    records and the forward's at this shape."""
    b, h, t = len(lengths), 16, 249
    q, k, v, do = _qkv(gen, b, h, t, torch.bfloat16, True, n=4)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                 return_lse=True)
    _, delta = attention.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do,
                                                     lens)
    calls = {
        "fwd": lambda: attention.flash_attention_bhtd_cuda(
            q, k, v, lens, return_lse=True),
        "dq": lambda: attention.flash_attention_bwd_dq_cuda(
            q, k, v, o, lse, do, lens),
        "dkv": lambda: attention.flash_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta, lens),
    }
    names = {"fwd": "flash_fwd_bf16", "dq": "flash_bwd_dq_bf16",
             "dkv": "flash_bwd_dkv_bf16"}
    dev = {n: device_ms(fn, 50, names[n]) for n, fn in calls.items()}
    wall = {n: cuda_ms(fn, 50) for n, fn in calls.items()}
    fwd_ms, dq_ms, dkv_ms = dev["fwd"], dev["dq"], dev["dkv"]
    plain = {
        "dq": device_ms(lambda: attention.flash_attention_bwd_dq_plain(
            q, k, v, o, lse, do, lens), 10),
        "dkv": device_ms(lambda: attention.flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta, lens), 10)}
    bwd_ms = device_ms(lambda: attention.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, lens), 50)
    ours_ms = device_ms(lambda: attention.flash_attention_bwd_cuda(
        q, k, v, *attention.flash_attention_bhtd_cuda(
            q, k, v, lens, return_lse=True), do, lens), 50)

    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)
        return torch.autograd.grad(out, (qs, ks, vs), do)

    sdpa_ms = device_ms(sdpa_fwd_bwd, 50)
    with torch.no_grad():
        sdpa_fwd_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 50)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask)
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True), 50)

    n = sum(min(x, t) for x in lengths)   # valid keys over the batch
    tile = h * 64 * 2                     # bytes of one bf16 row of all heads
    rows = 2 * h * 4                      # lse and delta, f32, all heads
    records = {}
    for name, ms, mults, nbytes in (
            # q.k^T, dO.v^T, ds.k; reads q, dO, o, lse (T rows), k, v (to
            # the length); writes dq, delta
            ("flash_attn_bwd_dq", dq_ms, 6,
             tile * (4 * b * t + 2 * n) + rows * b * t),
            # q.k^T, dO.v^T, p^T.dO, ds^T.q; reads q, dO, lse, delta, k, v;
            # writes dk, dv
            ("flash_attn_bwd_dkv", dkv_ms, 8,
             tile * (4 * b * t + 2 * n) + rows * b * t)):
        bound_ms, bound_by = bound(mults * h * 64 * t * n, nbytes)
        short = name[len("flash_attn_bwd_"):]
        records[name] = {
            "ms": ms, "plain_ms": plain[short],
            "plain_covers": ("dq and delta" if short == "dq" else "dk and dv")
                            + ": this kernel's plain version",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_bwd_ms,
            "library_covers": "dq, dk and dv: the backward of "
                              "scaled_dot_product_attention, its delta "
                              "included, against the two kernels' sum "
                              "(delta inside the dq kernel)",
            "wall_ms": wall[short]}
    fwd_bound_ms, fwd_bound_by = bound(
        4 * h * 64 * t * n, tile * (2 * b * t + 2 * n) + 4 * h * b * t)
    fwd_record = {"ms": fwd_ms, "bound_ms": fwd_bound_ms,
                  "bound_by": fwd_bound_by, "library_ms": sdpa_fwd_ms,
                  "wall_ms": wall["fwd"],
                  "covers": "the forward with its logsumexp at B=8, H=16, "
                            "T=249 against the SDPA forward (no "
                            "logsumexp output) on the same masked inputs"}
    log(f"  at B={b} H={h} T={t} D=64 bf16 (lengths {sorted(set(lengths))}):"
        f" flash_attn_fwd+lse {fwd_ms * 1e3:.1f} us (bound "
        f"{fwd_bound_ms * 1e3:.1f} us; sdpa forward "
        f"{sdpa_fwd_ms * 1e3:.1f} us); dq with delta {dq_ms * 1e3:.1f} us "
        f"(bound {records['flash_attn_bwd_dq']['bound_ms'] * 1e3:.1f} us, "
        f"{records['flash_attn_bwd_dq']['bound_by']}); dk/dv "
        f"{dkv_ms * 1e3:.1f} us (bound "
        f"{records['flash_attn_bwd_dkv']['bound_ms'] * 1e3:.1f} us, "
        f"{records['flash_attn_bwd_dkv']['bound_by']}); plain dq "
        f"{plain['dq'] * 1e3:.1f} us, plain dk/dv {plain['dkv'] * 1e3:.1f} us"
        f" (device times); a launch's wall time, back to back: fwd+lse "
        f"{wall['fwd'] * 1e3:.1f} us, dq {wall['dq'] * 1e3:.1f} us, dk/dv "
        f"{wall['dkv'] * 1e3:.1f} us")
    log(f"  backward, device time: dq + dk/dv (delta inside dq) "
        f"{(dq_ms + dkv_ms) * 1e3:.1f} us, all kernels of "
        f"flash_attention_bwd_cuda {bwd_ms * 1e3:.1f} us | sdpa backward "
        f"{sdpa_bwd_ms * 1e3:.1f} us | ratio "
        f"{(dq_ms + dkv_ms) / sdpa_bwd_ms:.2f}")
    log(f"  forward + backward, same masked problem, device time: ours "
        f"{ours_ms * 1e3:.1f} us (fwd+lse, dq with delta, dk/dv) | sdpa "
        f"{sdpa_ms * 1e3:.1f} us (of which its backward {sdpa_bwd_ms * 1e3:.1f}"
        f" us) | ratio {ours_ms / sdpa_ms:.2f}")
    return records, fwd_record


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers (8 significant bits) at |x|: with
    |x| = m·2^e, m in [0.5, 1), it is 2^(e − 8) (frexp is exact; a log2
    need not be at a power of two)."""
    _, exp = torch.frexp(x.float().abs().clamp(min=1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def fused_operands(gen, b, length, c_in, c_out, k, dtype, bias=True):
    """Unit-scale x (B, L, C_in), w (C_out, k, C_in) scaled to unit-scale
    outputs, bias and LayerNorm parameters near the model's."""
    x = torch.randn((b, length, c_in), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((c_out, k, c_in), generator=gen, device="cuda")
         / (k * c_in) ** 0.5).to(dtype)
    bb = (torch.randn((c_out,), generator=gen, device="cuda").to(dtype)
          if bias else None)
    ln_w = 1.0 + 0.1 * torch.randn((c_out,), generator=gen, device="cuda")
    ln_b = 0.1 * torch.randn((c_out,), generator=gen, device="cuda")
    return x, w, bb, ln_w, ln_b


def _check_fused(name, got, want, dtype):
    """One fused-conv result against its plain version: bf16 within one
    bf16 ulp of the output plus FUSED_BF16_ATOL, float32 within F32_TOL,
    finite and of the plain version's shape. Returns the max abs error."""
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(want) + FUSED_BF16_ATOL).all())
    else:
        ok = err.max().item() <= F32_TOL
    ok = ok and got.shape == want.shape and bool(
        torch.isfinite(got.float()).all())
    if not ok:
        raise AssertionError(f"the fused conv kernel disagrees with its "
                             f"plain version: {name}")
    return err.max().item()


def check_fused_cases(gen):
    """The fused kernel against its plain version: bf16 within one bf16
    ulp of the output plus FUSED_BF16_ATOL, float32 within F32_TOL; then x
    at the start of a NaN-filled buffer (nothing past x may be read) and a
    bit-for-bit relaunch. Returns the max abs error."""
    first, last = fe_input_lengths()[0], fe_input_lengths()[-1]
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, L, C_in, C_out, k, stride, dtype, bias)
    cases = [
        ("layer 1, 32 x 10 s", (32, first, 512, 512, 3, 2, bf16, True)),
        ("layer 6, 32 x 10 s, no bias", (32, last, 512, 512, 2, 2, bf16,
                                         False)),
        ("an item ends mid-tile: T_out 150", (3, 301, 512, 512, 3, 2, bf16,
                                              True)),
        ("T_out 1, k 3", (2, 3, 512, 512, 3, 2, bf16, True)),
        ("T_out 1, k 2, no bias", (1, 2, 512, 512, 2, 2, bf16, False)),
        ("C_out 128", (3, 401, 512, 128, 3, 2, bf16, True)),
        ("C_out 128, no bias", (2, 300, 128, 128, 2, 2, bf16, False)),
        ("C_out 256", (3, 401, 128, 256, 3, 2, bf16, True)),
        ("C_out 256, C_in 64, no bias", (2, 515, 64, 256, 3, 2, bf16,
                                         False)),
        ("stride 1", (2, 300, 512, 512, 2, 1, bf16, True)),
        ("stride 4", (2, 1001, 512, 256, 3, 4, bf16, False)),
        ("float32 variant", (4, 1601, 512, 512, 3, 2, f32, True)),
        ("float32 variant, C 128, no bias", (2, 301, 128, 128, 2, 2, f32,
                                             False)),
        ("float32 variant, T_out 1", (1, 3, 512, 512, 3, 2, f32, True)),
    ]
    # the edges of the 128-row tile and of a cluster of two row tiles
    for i, t_out in enumerate((127, 128, 129, 255, 256, 257)):
        cases.append((f"tile edge T_out {t_out}",
                      (2, 2 * t_out + 1, 512, 512, 3, 2, bf16, i % 2 == 0)))
    worst = 0.0
    for name, (b, length, c_in, c_out, k, stride, dtype, bias) in cases:
        x, w, bb, ln_w, ln_b = fused_operands(gen, b, length, c_in, c_out, k,
                                              dtype, bias)
        got = fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b, stride)
        torch.cuda.synchronize()
        want = fused_conv.fused_conv_ln_gelu_plain(x, w, bb, ln_w, ln_b,
                                                   stride)
        err = _check_fused(name, got, want, dtype)
        log(f"  fused_conv_ln_gelu {name}: x {tuple(x.shape)} {dtype} k {k} "
            f"stride {stride} -> T_out {got.shape[1]}, max_abs_err "
            f"{err:.3e}")
        worst = max(worst, err)
        del x, got, want

    # x at the start of a larger buffer whose other elements are NaN: a
    # read past x (or past an item into the next) would poison whole rows
    x, w, bb, ln_w, ln_b = fused_operands(gen, 3, 301, 512, 512, 3,
                                          torch.bfloat16)
    buf = torch.full((x.numel() + 64 * 512,), float("nan"),
                     dtype=torch.bfloat16, device="cuda")
    buf[:x.numel()] = x.reshape(-1)
    got = fused_conv.fused_conv_ln_gelu_cuda(
        buf[:x.numel()].view(x.shape), w, bb, ln_w, ln_b, 2)
    torch.cuda.synchronize()
    want = fused_conv.fused_conv_ln_gelu_plain(x, w, bb, ln_w, ln_b, 2)
    err = _check_fused("x followed by NaN", got, want, torch.bfloat16)
    worst = max(worst, err)
    log(f"  fused_conv_ln_gelu x at the start of a NaN-filled buffer: "
        f"finite, max_abs_err {err:.3e}")

    # a relaunch at layer 1's shape gives the same bits
    x, w, bb, ln_w, ln_b = fused_operands(gen, 32, first, 512, 512, 3,
                                          torch.bfloat16)
    one = fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b, 2)
    two = fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b, 2)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError("the fused conv kernel is not bit-identical "
                             "on a relaunch")
    log("  fused_conv_ln_gelu relaunch at layer 1's shape: bit-identical")
    return worst


def time_fused_layers(gen):
    """Each fused layer of a 32 x 10 s batch (bf16, C 512): the kernel's
    device time, its bound, the plain version's, and as a yardstick the
    chain of PyTorch calls that computes the same function (cuDNN conv1d
    on the channels-first view, float32 LayerNorm, exact GELU, bf16
    cast)."""
    import torch.nn.functional as F

    layers = []
    for i, (length, k) in enumerate(zip(fe_input_lengths(), FE_KERNELS),
                                    start=1):
        x, w, bb, ln_w, ln_b = fused_operands(gen, 32, length, 512, 512, k,
                                              torch.bfloat16)
        w_hf = w.permute(0, 2, 1).contiguous()  # (C_out, C_in, k)
        t_out = (length - k) // 2 + 1

        def chain():
            y = F.conv1d(x.transpose(1, 2), w_hf, bb, stride=2)
            y = F.layer_norm(y.transpose(1, 2).float(), (512,), ln_w, ln_b)
            return F.gelu(y).to(torch.bfloat16)

        ms = device_ms(lambda: fused_conv.fused_conv_ln_gelu_cuda(
            x, w, bb, ln_w, ln_b, 2), 20, "fused_conv_ln_gelu_bf16")
        plain_ms = device_ms(lambda: fused_conv.fused_conv_ln_gelu_plain(
            x, w, bb, ln_w, ln_b, 2), 3)
        chain_ms = device_ms(chain, 10)
        flops = 2 * 32 * t_out * k * 512 * 512
        nbytes = 2 * 32 * (length + t_out) * 512 + 2 * k * 512 * 512 + 12 * 512
        bound_ms, bound_by = bound(flops, nbytes)
        layers.append({"layer": i, "x": [32, length, 512], "k": k,
                       "t_out": t_out, "ms": ms, "plain_ms": plain_ms,
                       "chain_ms": chain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                       "tflops": flops / (ms * 1e-3) / 1e12})
        log(f"  fused_conv_ln_gelu layer {i} (x (32, {length}, 512), k {k}, "
            f"T_out {t_out}): {ms * 1e3:.1f} us | plain {plain_ms * 1e3:.1f} "
            f"us | conv->LN->GELU chain {chain_ms * 1e3:.1f} us | bound "
            f"{bound_ms * 1e3:.1f} us ({bound_by}) | "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        del x
    total = {key: sum(l[key] for l in layers)
             for key in ("ms", "plain_ms", "chain_ms", "flops", "bytes")}
    bound_ms, bound_by = bound(total["flops"], total["bytes"])
    log(f"  fused_conv_ln_gelu, the six launches of a 32 x 10 s batch: "
        f"{total['ms'] * 1e3:.1f} us | plain {total['plain_ms'] * 1e3:.1f} us"
        f" | chain {total['chain_ms'] * 1e3:.1f} us | bound "
        f"{bound_ms * 1e3:.1f} us ({bound_by})")
    return {"ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "chain_ms": total["chain_ms"],
            "ms_covers": "the six launches of one 32 x 10 s bf16 batch "
                         "(feature-extractor layers 1-6), device time",
            "chain_covers": "a chain of calls, not one library call: cuDNN "
                            "conv1d, float32 F.layer_norm, exact F.gelu, "
                            "bf16 cast, on the same channels-last input",
            "per_layer": layers}


def phase_kernels(train_lengths):
    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    b, h, t = 32, 16, 499
    ragged = [0, 1, t] + rng.integers(2, t + 1, b - 3).tolist()
    ragged_train = [0, 1, 249] + rng.integers(2, 250, 5).tolist()
    cases = [
        ("serving shape, model layout", (b, h, t, torch.bfloat16, True),
         ragged),
        ("serving shape, contiguous", (b, h, t, torch.bfloat16, False),
         ragged),
        ("training shape, model layout", (8, h, 249, torch.bfloat16, True),
         ragged_train),
        ("training shape, batch lengths", (8, h, 249, torch.bfloat16, True),
         train_lengths),
        ("T=1100, several tiles, ragged", (4, h, 1100, torch.bfloat16,
                                            False), [1100, 700, 0, 1]),
        # the edges of the 64-row and 64-key tiles
        ("tile edges, T=65", (4, h, 65, torch.bfloat16, True),
         [65, 64, 63, 1]),
        ("tile edges, T=128", (4, h, 128, torch.bfloat16, True),
         [128, 127, 65, 64]),
        ("tile edges, T=129", (6, h, 129, torch.bfloat16, True),
         [129, 128, 127, 65, 64, 63]),
        ("tile edges, T=257", (6, h, 257, torch.bfloat16, False),
         [257, 256, 255, 193, 192, 129]),
        ("float32 variant", (4, 4, 300, torch.float32, True),
         [300, 0, 1, 150]),
        ("float32 variant, T=1100", (2, 2, 1100, torch.float32, False),
         [1100, 65]),
    ]
    errs = {name: 0.0 for name in FLASH}
    for name, (bb, hh, tt, dtype, layout), lengths in cases:
        q, k, v, do = _qkv(gen, bb, hh, tt, dtype, layout, n=4)
        for kname, err in check_kernel_case(name, q, k, v, do,
                                            lengths).items():
            errs[kname] = max(errs[kname], err)

    errs["fused_conv_ln_gelu"] = check_fused_cases(gen)

    records = {"flash_attn_fwd": time_forward(gen)}
    train_records, fwd_training = time_training_kernels(gen, train_lengths)
    records["flash_attn_fwd"]["at_training_shape"] = fwd_training
    records.update(train_records)
    records["fused_conv_ln_gelu"] = time_fused_layers(gen)
    torch.cuda.empty_cache()
    replaces = {
        "flash_attn_fwd": ("flash_attn_fwd.cu", "attention.py:64"),
        "flash_attn_bwd_dq": ("flash_attn_bwd.cu", "attention.py:170"),
        "flash_attn_bwd_dkv": ("flash_attn_bwd.cu", "attention.py:216"),
        "fused_conv_ln_gelu": ("fused_conv_ln_gelu.cu", "fused_conv.py:83")}
    out = []
    for name, rec in records.items():
        src, where = replaces[name]
        out.append({"name": name, "route": "cuda",
                     "source": f"aptai_tpu_torch/csrc/{src}",
                     "replaces": f"aptai_tpu/ops/{where}",
                     "launches": None, "launches_by_path": None,
                     "max_abs_err": errs[name], **rec})
    return out


# -- phase 3 ------------------------------------------------------------------

def pearson(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def check_small_reference(device="cuda", what="small f32 model",
                          **overrides):
    """A small float32 model (head dim 64; ``overrides`` of its config)
    on ``device`` against the same weights on the CPU, which runs the
    plain attention."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, **overrides)
    model = random_aptai(cfg, seed=1, num_phonemes=46)
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_000, 31_000, 9_000)]
    cpu = APTAIPredictor(model, device="cpu").predict_batch(wavs)
    cpu = {k: v.numpy().copy() for k, v in cpu.items()}
    gpu = APTAIPredictor(model, device=device).predict_batch(wavs)
    gpu = {k: v.cpu().numpy() for k, v in gpu.items()}
    err_tv = float(np.abs(gpu["tvs_pred"] - cpu["tvs_pred"]).max())
    err_p = float(np.abs(gpu["phn_fc_probs"] - cpu["phn_fc_probs"]).max())
    log(f"  {what}, card vs CPU: tvs max_abs_err {err_tv:.2e}, "
        f"probs max_abs_err {err_p:.2e}")
    if not (np.array_equal(gpu["frame_lengths"], cpu["frame_lengths"])
            and err_tv <= 1e-3 and err_p <= 1e-4):
        raise AssertionError(f"{what}: the card disagrees with the CPU "
                             f"reference")


def check_result(res, n_samples, cfg):
    n = int(cfg.feat_extract_output_lengths(n_samples))
    tv, phn = res["tvs_pred"], res["phn_fc_pred"]
    probs = res["phn_fc_probs"]
    ok = (int(res["frame_lengths"]) == n and tv.shape == (n, 9)
          and phn.shape == (n,) and probs.shape == (n, 46)
          and np.isfinite(tv).all() and np.isfinite(probs).all())
    if not ok:
        raise AssertionError(f"bad result for a {n_samples}-sample request: "
                             f"frames {res['frame_lengths']}, tvs {tv.shape}")


def phase_slice(cfg, pred):
    log("== phase 3: serving")
    check_small_reference()
    batches = []

    def serve(wavs, fields=None, real_rows=None):
        batches.append(len(wavs))
        return pred.predict_batch(wavs, fields=fields, real_rows=real_rows)

    rng = np.random.default_rng(0)
    seconds = (1.0, 10.0, 2.3, 4.7, 6.1, 7.9, 3.3, 8.6)
    wavs = [(rng.standard_normal(int(s * SAMPLE_RATE)) * 0.1).astype(
        np.float32) for s in seconds]
    mb = MicroBatcher(serve, max_batch_size=8, max_wait_ms=20.0)
    mb.warmup(seconds=10.0, cycles=1)
    batches.clear()

    reset_counts()
    mb.start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(w) for w in wavs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        mb.stop()
    counts = read_counts()
    launches = counts["flash_attn_fwd"]
    n_batches = len(batches)

    for res, w in zip(results, wavs):
        check_result(res, len(w), cfg)
    log(f"  served {len(wavs)} requests ({sum(seconds):.1f} audio-s) in "
        f"{n_batches} batch(es) of {batches} in {serve_s:.3f} s; "
        f"launches {counts}")
    if (launches != cfg.num_hidden_layers * n_batches or launches == 0
            or counts["flash_attn_bwd_dq"] or counts["flash_attn_bwd_dkv"]
            or counts["fused_conv_ln_gelu"]):
        raise AssertionError(f"expected {cfg.num_hidden_layers} forward "
                             f"launches per batch, no backward and no fused "
                             f"conv (the flag is off), got {counts} over "
                             f"{n_batches} batch(es)")

    kernel_out = mb.run_batch(wavs)
    w2v.multi_head_attention_bhtd = attention.flash_attention_bhtd_plain
    try:
        plain_out = mb.run_batch(wavs)
    finally:
        w2v.multi_head_attention_bhtd = attention.multi_head_attention_bhtd
    tv_k = np.concatenate([r["tvs_pred"] for r in kernel_out])
    tv_p = np.concatenate([r["tvs_pred"] for r in plain_out])
    rs = [pearson(tv_k[:, i], tv_p[:, i]) for i in range(9)]
    agree = float(np.mean(np.concatenate(
        [a["phn_fc_pred"] == b["phn_fc_pred"]
         for a, b in zip(kernel_out, plain_out)])))
    log(f"  kernel vs plain attention, same batch: per-TV Pearson min "
        f"{min(rs):.6f}, phoneme argmax agreement {agree:.4%}")
    if min(rs) < 0.999 or agree < 0.99:
        raise AssertionError("the slice through the kernel disagrees with "
                             "the plain attention")
    return counts, n_batches


# -- phase 3b -----------------------------------------------------------------

def small_pr_config():
    """A small float32 W2V2PR (head dim 64) whose conv layers 1 and 2 take
    the fused path (C 128: the kernel's float32 variant on the card)."""
    return tiny_config(hidden_size=128, num_attention_heads=2,
                       intermediate_size=256, conv_dim=(128,) * 3,
                       vocab_size=46, fused_feature_extractor=True, **NO_DROP)


def check_small_pr_reference(device: str = "cuda"):
    """The small float32 W2V2PR on the card against the same weights on
    the CPU, which runs the plain fused op and plain attention: logits,
    CTC loss and greedy sequences."""
    cfg = small_pr_config()
    model = random_w2v2_pr(cfg, seed=1).eval()
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((3, 31_000)) * 0.1).astype(np.float32)
    lens = np.array([31_000, 20_000, 9_000], np.int32)
    audio[1, 20_000:] = 0.0
    audio[2, 9_000:] = 0.0
    labels = np.array([[5, 5, 9, 1, 30, 2, 7], [4, 17, 17, 2, 45, -100, -100],
                       [3, 8, -100, -100, -100, -100, -100]], np.int64)
    runs = {}
    for dev in ("cpu", device):
        m = copy.deepcopy(model).to(dev)
        reset_counts()
        with torch.no_grad():
            out = m(*(torch.from_numpy(a).to(dev)
                      for a in (audio, lens, labels)))
            toks, n = greedy_decode(out["phoneme_logits"],
                                    out["frame_lengths"])
        runs[dev] = ({k: v.cpu() for k, v in out.items()}, toks.cpu(),
                     n.cpu(), read_counts()["fused_conv_ln_gelu"])
    (oc, tc, nc, _), (og, tg, ng, fused_launches) = runs["cpu"], runs[device]
    err = (og["phoneme_logits"] - oc["phoneme_logits"]).abs().max().item()
    same = [bool(ng[b] == nc[b]) and torch.equal(tg[b, :nc[b]], tc[b, :nc[b]])
            for b in range(3)]
    log(f"  small f32 W2V2PR, card vs CPU: logits max_abs_err {err:.2e}, "
        f"loss {og['loss'].item():.6f} vs {oc['loss'].item():.6f}, greedy "
        f"sequences identical {same} ({nc.tolist()} tokens), fused launches "
        f"on the card {fused_launches}")
    # float32 in both: summation order, erf and exp ulps
    if not (torch.equal(og["frame_lengths"], oc["frame_lengths"])
            and err <= 1e-3 and all(same) and fused_launches == 2
            and abs(og["loss"].item() - oc["loss"].item())
            <= 1e-4 * abs(oc["loss"].item())):
        raise AssertionError("the card's W2V2PR disagrees with the CPU's")


def check_pr_result(res, n_samples, cfg):
    n = int(cfg.feat_extract_output_lengths(n_samples))
    ok = (int(res["frame_lengths"]) == n
          and res["phoneme_logits"].shape == (n, cfg.vocab_size)
          and res["last_transf_hidden"].shape == (n, cfg.hidden_size)
          and res["features_hidden"].shape == (n, cfg.conv_dim[-1])
          and all(np.isfinite(res[k]).all() for k in (
              "phoneme_logits", "last_transf_hidden", "features_hidden")))
    if not ok:
        raise AssertionError(f"bad W2V2PR result for a {n_samples}-sample "
                             f"request: frames {res['frame_lengths']}")


def edit_distance(a, b) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def output_agreement(got, want):
    """Per-frame argmax agreement of two runs' phoneme logits, and their
    greedy CTC sequences: identical items, and the token error rate
    (edit distance over ``want``'s tokens)."""
    def greedy(res):
        ids = res["phoneme_logits"].argmax(-1)
        keep = (ids != 0) & np.concatenate([[True], ids[1:] != ids[:-1]])
        return ids[keep].tolist()

    agree = float(np.mean(np.concatenate([
        a["phoneme_logits"].argmax(-1) == b["phoneme_logits"].argmax(-1)
        for a, b in zip(got, want)])))
    seqs = [(greedy(a), greedy(b)) for a, b in zip(got, want)]
    same = sum(a == b for a, b in seqs)
    ter = (sum(edit_distance(a, b) for a, b in seqs)
           / max(sum(len(b) for _, b in seqs), 1))
    return {"argmax": agree, "same": same, "ter": ter,
            "text": f"logits argmax agreement {agree:.4%}, greedy sequences "
                    f"identical on {same} of {len(seqs)} items, token error "
                    f"rate {ter:.4%}"}


def phase_pr_serving(pr_cfg, pr_pred):
    log("== phase 3b: W2V2PR serving, fused feature extractor")
    check_small_pr_reference()
    batches = []

    def serve(wavs, fields=None, real_rows=None):
        batches.append(len(wavs))
        return pr_pred.encode_batch(wavs, fields=fields, real_rows=real_rows)

    rng = np.random.default_rng(5)
    seconds = (1.0, 10.0, 2.3, 4.7, 6.1, 7.9, 3.3, 8.6)
    wavs = [(rng.standard_normal(int(sec * SAMPLE_RATE)) * 0.1).astype(
        np.float32) for sec in seconds]
    mb = MicroBatcher(serve, max_batch_size=8, max_wait_ms=20.0)
    mb.warmup(seconds=10.0, cycles=1)
    batches.clear()

    reset_counts()
    mb.start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(w) for w in wavs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        mb.stop()
    counts = read_counts()
    n_batches = len(batches)
    for res, w in zip(results, wavs):
        check_pr_result(res, len(w), pr_cfg)
    log(f"  served {len(wavs)} requests ({sum(seconds):.1f} audio-s) in "
        f"{n_batches} batch(es) of {batches} in {serve_s:.3f} s; launches "
        f"{counts}")
    if not (n_batches and counts["fused_conv_ln_gelu"] == 6 * n_batches
            and counts["flash_attn_fwd"] == pr_cfg.num_hidden_layers
            * n_batches and not counts["flash_attn_bwd_dq"]
            and not counts["flash_attn_bwd_dkv"]):
        raise AssertionError(f"expected 6 fused and "
                             f"{pr_cfg.num_hidden_layers} flash-forward "
                             f"launches per batch, got {counts} over "
                             f"{n_batches} batch(es)")

    # the same batch with the fused layers forced to the plain version; and,
    # as the model's own noise floor, the plain version on the waveforms
    # scaled by 1 + 2^-9 (half a bf16 ulp: about half of layer 0's input
    # roundings flip), since random weights over 24 layers carry a
    # one-ulp difference anywhere into some argmax flips
    kernel_out = mb.run_batch(wavs)
    w2v.fused_conv_ln_gelu = fused_conv.fused_conv_ln_gelu_plain
    try:
        reset_counts()
        plain_out = mb.run_batch(wavs)
        plain_counts = read_counts()
        nudged_out = mb.run_batch([w * np.float32(1 + 2 ** -9) for w in wavs])
    finally:
        w2v.fused_conv_ln_gelu = fused_conv.fused_conv_ln_gelu
    feat_err = max(float(np.abs(a["features_hidden"]
                                - b["features_hidden"]).max())
                   for a, b in zip(kernel_out, plain_out))
    kernel_vs_plain = output_agreement(kernel_out, plain_out)
    floor = output_agreement(nudged_out, plain_out)
    log(f"  fused kernel vs plain fused op, same batch: features max_abs_err "
        f"{feat_err:.3e}; {kernel_vs_plain['text']}")
    log(f"  noise floor, plain on the waveforms x (1 + 2^-9) vs plain: "
        f"{floor['text']}")
    # bounds: the features within a few bf16 ulps of their magnitude (up
    # to 8: 2^-4), and the kernel moving the output no more than the
    # nudge does (one point of slack on each rate), and argmax >= 95 %
    ok = (feat_err <= 2 ** -4 and not plain_counts["fused_conv_ln_gelu"]
          and kernel_vs_plain["argmax"] >= 0.95
          and kernel_vs_plain["argmax"] >= floor["argmax"] - 0.01
          and kernel_vs_plain["ter"] <= floor["ter"] + 0.01)
    if not ok:
        raise AssertionError("W2V2PR through the fused kernel disagrees with "
                             "the plain fused op beyond the noise floor")

    emb = pr_pred.get_embeddings(wavs[:2])
    n = emb["frame_seq_lens"]
    durs = [pr_pred.predict_phonemes_durations(w) for w in wavs[:2]]
    log(f"  get_embeddings on 2 items: features {emb['features_hidden'].shape}"
        f", hidden {emb['last_transf_hidden'].shape}, logits "
        f"{emb['phoneme_logits'].shape}, frames {n.tolist()}, beam tokens "
        f"{[len(x) for x in emb['phn_pred_seq_idx']]}; "
        f"predict_phonemes_durations: tokens "
        f"{[len(d['phn_seq_idx']) for d in durs]}, last start "
        f"{[round(d['phn_seq_dur'][-1], 3) if d['phn_seq_dur'] else None for d in durs]} s")
    t = emb["phoneme_logits"].shape[2]
    ok = (emb["features_hidden"].shape == (2, pr_cfg.conv_dim[-1], t)
          and emb["last_transf_hidden"].shape == (2, pr_cfg.hidden_size, t)
          and emb["phoneme_logits"].shape == (2, pr_cfg.vocab_size, t)
          and all(0 < s.max() < pr_cfg.vocab_size if len(s) else True
                  for s in emb["phn_pred_seq_idx"]))
    for d, w in zip(durs, wavs[:2]):
        times = d["phn_seq_dur"]
        ok = ok and len(times) == len(d["phn_seq_idx"]) and all(
            0 <= a <= b <= len(w) / SAMPLE_RATE
            for a, b in zip(times, times[1:] + [len(w) / SAMPLE_RATE]))
    if not ok:
        raise AssertionError("bad get_embeddings / predict_phonemes_durations")
    return counts, n_batches


# -- phase 4 ------------------------------------------------------------------

def device_kernels(prof):
    """The profile's device entries by name, without the device-side spans
    of host ranges (``record_function``, ``Optimizer.step``), which cover
    kernels counted on their own."""
    from torch.autograd import DeviceType

    ranges = {e.name for e in prof.events()
              if e.device_type == DeviceType.CPU}
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and e.key not in ranges]


def profile_breakdown(fn, what: str, top: int = 15):
    """One profiled call of ``fn``: device kernel time against wall time,
    and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    log(f"  profiler, {what}: kernels {busy_ms:.2f} ms of {wall * 1e3:.2f} "
        f"ms wall (device idle {1 - busy_ms / (wall * 1e3):.1%}, profiler "
        f"on); top kernels:")
    for e in sorted(gpu, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:5d}x  {e.key[:100]}")
    return busy_ms, wall * 1e3, prof


def phase_throughput(cfg, pred, card):
    log("== phase 4: serving throughput, predict_batch at 32 x 10 s")
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    for _ in range(2):
        pred.predict_batch(wavs)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(wavs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    flops = 32 * aptai_forward_flops(cfg, 10 * SAMPLE_RATE)
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  batch times (s): {[round(x, 5) for x in times]}")
    log(f"  {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms per batch, "
        f"MFU {'not known for this card' if util is None else f'{util:.4f}'}"
        f" ({flops / 1e12:.2f} TFLOP per batch) on {card}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_breakdown(lambda: pred.predict_batch(wavs), "one batch")


# -- phase 4b -----------------------------------------------------------------

def timed_batches(fn, n: int = 5, warmup: int = 2):
    """Host times of ``n`` calls of ``fn``, each bracketed by
    synchronisations, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_pr_throughput(pr_cfg, pr_pred, card):
    log("== phase 4b: W2V2PR encode_batch at 32 x 10 s")
    rng = np.random.default_rng(6)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    times = timed_batches(lambda: pr_pred.encode_batch(wavs))
    sec = float(np.median(times))
    flops = 32 * pr_forward_flops(pr_cfg, 10 * SAMPLE_RATE)
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  batch times (s): {[round(x, 5) for x in times]}")
    log(f"  {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms per batch, "
        f"MFU {'not known for this card' if util is None else f'{util:.4f}'}"
        f" ({flops / 1e12:.2f} TFLOP per batch) on {card}")
    profile_breakdown(lambda: pr_pred.encode_batch(wavs), "one W2V2PR batch")


def phase_fused_ab(cfg, aptai_model, pred_off, card):
    """APTAI predict_batch at 32 x 10 s with the fused feature extractor
    off and on (the same weights), alternated off, on, on, off in this
    process; then each case's feature extractor alone under the profiler."""
    log("== phase 4b: APTAI serving, fused_feature_extractor off / on")
    cfg_on = dataclasses.replace(cfg, fused_feature_extractor=True)
    model_on = APTAI(cfg_on)
    model_on.load_state_dict(aptai_model.state_dict())
    pred_on = APTAIPredictor(model_on)
    del model_on
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    preds = {"off": pred_off, "on": pred_on}
    # the two agree to bf16 rounding: the fused layers' exact GELU and
    # float32 LayerNorm against the unfused bf16 path's tanh GELU
    a = pred_off.predict_batch(wavs, fields=("phn_fc_pred",))
    b = pred_on.predict_batch(wavs, fields=("phn_fc_pred",))
    agree = (a["phn_fc_pred"] == b["phn_fc_pred"]).float().mean().item()
    legs = []
    for name in ("off", "on", "on", "off"):
        times = timed_batches(lambda: preds[name].predict_batch(wavs))
        sec = float(np.median(times))
        legs.append((name, sec))
        log(f"  {name}: {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms "
            f"per batch (batches {[round(x * 1e3, 2) for x in times]} ms)")
    mean = {n: np.mean([32 * 10 / s for m, s in legs if m == n])
            for n in ("off", "on")}
    log(f"  mean audio-s/s: off {mean['off']:.1f}, on {mean['on']:.1f} "
        f"({mean['on'] / mean['off'] - 1:+.2%}) on {card}; phoneme argmax "
        f"agreement off vs on {agree:.4%}")
    audio = torch.from_numpy(np.stack(wavs)).to(pred_off.device,
                                                 torch.bfloat16)
    for name, pred in preds.items():
        fe = pred.model.wav2vec2.feature_extractor
        with torch.inference_mode():
            profile_breakdown(lambda: fe(audio),
                              f"the feature extractor alone, flag {name}",
                              top=8)
    del pred_on
    torch.cuda.empty_cache()
    return mean


# -- phase 5 ------------------------------------------------------------------

def train_batch(cfg, b: int = 8, seconds: int = 5, seed: int = 0):
    """The JAX package's training benchmark batch: b x ``seconds`` of
    noise, every frame valid, random phoneme ids 1-45 and TV targets."""
    rng = np.random.default_rng(seed)
    samples = seconds * SAMPLE_RATE
    t = int(cfg.feat_extract_output_lengths(samples))
    return {
        "audio": (rng.standard_normal((b, samples)) * 0.1).astype(np.float32),
        "audio_lengths": np.full(b, samples, np.int32),
        "phn_frames": rng.integers(1, 46, (b, t)).astype(np.int32),
        "tv_targets": rng.standard_normal((b, t, 9)).astype(np.float32),
    }


def flat_grads(model, prefix=""):
    """{name: grad} of the parameters under ``prefix`` that have one, and
    their concatenation (float32, on the parameters' device)."""
    named = {n: p.grad.detach() for n, p in model.named_parameters()
             if p.grad is not None and n.startswith(prefix)}
    return named, torch.cat([g.float().flatten() for g in named.values()])


def compare_grads(what, named_a, flat_a, named_b, flat_b, max_rel, min_cos):
    if set(named_a) != set(named_b):
        raise AssertionError(f"{what}: different parameters have gradients")
    # in float64: a float32 cosine of ~1e6 terms is itself off by ~1e-7,
    # coarser than the 1e-8 that float32 gradients are held to
    flat_a, flat_b = flat_a.double(), flat_b.to(flat_a.device).double()
    rel = ((flat_a - flat_b).norm() / flat_b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(flat_a, flat_b, dim=0).item()
    worst = max(named_b, key=lambda n: (
        (named_a[n].float() - named_b[n].float().to(flat_a.device)).norm()
        / named_b[n].float().norm().clamp(min=1e-30)).item())
    log(f"  {what}: {len(named_a)} gradients, relative L2 {rel:.3e} "
        f"(bound {max_rel}), cosine {cos:.12f} (bound {min_cos}); worst "
        f"tensor {worst}")
    if not (rel <= max_rel and cos >= min_cos):
        raise AssertionError(f"{what}: gradients disagree")


def check_small_train_reference():
    """A small float32 model's train step (head dim 64, dropout and
    SpecAugment off) on the card against the same step on the CPU, which
    runs the plain attention forward and backward."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, mask_time_prob=0.0, **NO_DROP)
    batch = train_batch(cfg, b=3, seconds=1, seed=3)
    batch["audio_lengths"] = np.array([16_000, 11_000, 6_000], np.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = random_aptai(cfg, seed=1, tv_drop=0.0, phn_drop=0.0)
        step = TrainStep(model, torch_adam(model), device=dev)
        loss = step(batch, 1e-3)["loss"].item()
        runs[dev] = (loss,) + flat_grads(model)
    (lc, gc, fc), (lg, gg, fg) = runs["cpu"], runs["cuda"]
    log(f"  small f32 train step, card vs CPU: loss {lg:.6f} vs {lc:.6f}")
    if not (np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
        raise AssertionError("the card's loss disagrees with the CPU's")
    # float32 in both: only summation order and exp ulps differ
    compare_grads("small f32 train step, card vs CPU", gg, fg, gc, fc,
                  max_rel=1e-4, min_cos=0.99999999)


def timed_steps(step, batch, n: int):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch, 1e-5)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, m


def grads_kernels_vs_plain(model, inputs, layers, what):
    """The loss and the gradients of every encoder tensor of ``model`` on
    ``inputs`` through the kernels (``layers`` launches of each) and
    through plain attention autograd (none), held to relative L2 ≤ 0.1 and
    cosine ≥ 0.99: bf16 activations round at other points in the two
    versions (the kernel rounds p and ds, plain autograd its own
    intermediates) and 24 layers compound the differences. Returns the
    kernels' gradients by name."""

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        out = model(*inputs)
        out["loss"].backward()
        return (out["loss"].item(),) + flat_grads(model, "wav2vec2.")

    reset_counts()
    lk, gk, fk = loss_and_grads()
    counts_k = read_counts()
    w2v.multi_head_attention_bhtd = attention.flash_attention_bhtd_plain
    try:
        reset_counts()
        lp, gp, fp = loss_and_grads()
        counts_p = read_counts()
    finally:
        w2v.multi_head_attention_bhtd = attention.multi_head_attention_bhtd
    model.zero_grad(set_to_none=True)
    log(f"  no dropout, kernels vs plain attention (autograd): loss "
        f"{lk:.6f} vs {lp:.6f}; launches {counts_k} vs {counts_p}")
    if any(counts_p.values()) or any(counts_k[n] != layers for n in FLASH):
        raise AssertionError("the kernel and plain runs took the wrong path")
    compare_grads(what, gk, fk, gp, fp, max_rel=0.1, min_cos=0.99)
    return gk


def checked_first_step(step, batch, layers):
    """The first step with the launch counts read around it: a finite
    loss, ``layers`` launches of each flash kernel, no fused conv, and Δ
    left to the dq kernel (not computed as tensor ops)."""
    delta_calls = []
    real_delta = attention.attention_delta
    attention.attention_delta = (
        lambda *a: delta_calls.append(1) or real_delta(*a))
    try:
        reset_counts()
        loss0 = step(batch, 1e-5)["loss"].item()
        counts = read_counts()
    finally:
        attention.attention_delta = real_delta
    log(f"  first step: loss {loss0:.5f}, launches {counts}, delta as "
        f"tensor ops {len(delta_calls)} times")
    if not (np.isfinite(loss0) and all(counts[n] == layers for n in FLASH)
            and counts["fused_conv_ln_gelu"] == 0 and not delta_calls):
        raise AssertionError(f"expected {layers} launches of each kernel "
                             f"per step, no delta outside the dq kernel and "
                             f"a finite loss, got {counts}, "
                             f"{len(delta_calls)}, {loss0}")
    return loss0, counts


def phase_train(card):
    log("== phase 5: the train step at 8 x 5 s")
    check_small_train_reference()

    cfg = Wav2Vec2Config(dtype="bfloat16")
    batch = train_batch(cfg)
    b, samples = batch["audio"].shape
    model = random_aptai(cfg, seed=0)
    fe_prefix = "wav2vec2.feature_extractor."
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, torch_adam(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    loss0, counts = checked_first_step(step, batch, cfg.num_hidden_layers)
    want = cfg.num_hidden_layers

    timed_steps(step, batch, 1)  # the second warm-up step
    reset_counts()
    times, m = timed_steps(step, batch, 5)
    counts5 = read_counts()
    sec = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = training_step_flops(b * aptai_forward_flops(cfg, samples))
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  step times (s): {[round(x, 5) for x in times]}; launches over "
        f"them {counts5}; last loss {m['loss'].item():.5f}")
    log(f"  {b * samples / SAMPLE_RATE / sec:.1f} train audio-s/s, "
        f"{sec * 1e3:.2f} ms per step, MFU "
        f"{'not known for this card' if util is None else f'{util:.4f}'} "
        f"({flops / 1e12:.2f} TFLOP per step, 3x forward) on {card}; peak "
        f"memory {peak:.2f} GiB")
    if any(counts5[n] != 5 * want for n in FLASH):
        raise AssertionError(f"launches over 5 steps: {counts5}")
    profile_breakdown(lambda: step(batch, 1e-5), "one train step", top=20)

    unchanged = [n for n, p in model.named_parameters()
                 if not n.startswith(fe_prefix)
                 and torch.equal(p.detach().cpu(), before[n])]
    fe_same = all(torch.equal(p.detach().cpu(), before[n])
                  for n, p in model.named_parameters()
                  if n.startswith(fe_prefix))
    log(f"  after {step.step_count} steps: feature encoder bit-identical "
        f"{fe_same}; trainable tensors unchanged: {unchanged}")
    if not fe_same or unchanged:
        raise AssertionError("the frozen feature encoder moved, or a "
                             "trainable parameter did not")
    del before

    # the same batch, no dropout or SpecAugment, kernels vs plain attention
    model.eval()
    grads_kernels_vs_plain(model, [torch.as_tensor(batch[k]).cuda() for k in (
        "audio", "audio_lengths", "phn_frames", "tv_targets")], want,
        "encoder gradients, kernels vs plain")
    del step, model
    torch.cuda.empty_cache()

    # one step with per-layer recomputation: the forward runs twice
    model = random_aptai(dataclasses.replace(cfg, remat_policy="full"),
                         seed=0)
    step = TrainStep(model, torch_adam(model))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss_full = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    counts_full = read_counts()
    log(f"  remat_policy='full': first step loss {loss_full:.5f} (none: "
        f"{loss0:.5f}), launches {counts_full}, {full_s * 1e3:.1f} ms "
        f"(with warm-up), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (counts_full["flash_attn_fwd"] == 2 * want
            and counts_full["flash_attn_bwd_dq"] == want
            and counts_full["flash_attn_bwd_dkv"] == want
            and abs(loss_full - loss0) <= 1e-3 * abs(loss0)):
        raise AssertionError("the remat step took the wrong path or loss")
    del step, model
    torch.cuda.empty_cache()

    # one step with the fused feature extractor: the encoder is frozen, so
    # the six fused layers run under no_grad and need no backward
    model = random_aptai(dataclasses.replace(cfg,
                                             fused_feature_extractor=True),
                         seed=0)
    step = TrainStep(model, torch_adam(model))
    reset_counts()
    loss_fused = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    counts_fused = read_counts()
    log(f"  fused_feature_extractor=True: first step loss {loss_fused:.5f} "
        f"(off: {loss0:.5f}; the fused layers' exact GELU and f32 "
        f"LayerNorm differ from the unfused bf16 path), launches "
        f"{counts_fused}")
    n_fused = sum(b.fused for b in model.wav2vec2.feature_extractor
                  .conv_layers)
    if not (np.isfinite(loss_fused) and n_fused == 6
            and counts_fused["fused_conv_ln_gelu"] == n_fused
            and all(counts_fused[n] == want for n in FLASH)):
        raise AssertionError("the fused-FE train step took the wrong path")
    del step, model
    torch.cuda.empty_cache()
    check_fused_refuses_gradients()
    return ({name: counts[name] for name in COUNTED},
            {name: counts_fused[name] for name in COUNTED})


def check_fused_refuses_gradients(device: str = "cuda"):
    """W2V2PR with a trainable feature encoder and the fused flag on: a
    forward that needs the encoder's gradient raises on the card, before
    any fused launch."""
    cfg = small_pr_config()
    model = random_w2v2_pr(cfg, seed=1).to(device).train()
    audio = torch.zeros((2, 16_000), device=device)
    lens = torch.tensor([16_000, 9_000], dtype=torch.int32, device=device)
    labels = torch.tensor([[1, 2, 3], [4, -100, -100]], device=device)
    reset_counts()
    try:
        model(audio, lens, labels)
    except NotImplementedError as e:
        log(f"  W2V2PR, trainable encoder, fused flag on, on the card: "
            f"NotImplementedError ({str(e)[:60]}...), fused launches "
            f"{read_counts()['fused_conv_ln_gelu']}")
    else:
        raise AssertionError("a trainable encoder ran the fused op")
    if read_counts()["fused_conv_ln_gelu"]:
        raise AssertionError("the fused kernel launched before the refusal")


# -- phase 5b -----------------------------------------------------------------

def pr_train_batch(cfg, b: int = 8, seconds: int = 5, seed: int = 0,
                   lengths=None):
    """The train batch's audio and lengths (``train_batch``; ``lengths``
    in samples silences each item past its length) with ``phoneme_labels``
    of 40-70 ids in 1..vocab-1 from ``seed``, padded with -100: feasible
    at 249 frames, so the CTC loss measures real work."""
    base = train_batch(cfg, b, seconds, seed)
    audio, lens = base["audio"], base["audio_lengths"]
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        for i, n in enumerate(lens):
            audio[i, n:] = 0.0
    rng = np.random.default_rng(seed + 1)
    labels = np.full((b, 70), -100, np.int64)
    for i, n in enumerate(rng.integers(40, 71, b)):
        labels[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return {"audio": audio, "audio_lengths": lens, "phoneme_labels": labels}


def check_small_pr_train_reference():
    """Two Adam steps (lr 1e-5) of a small float32 W2V2PR (head dim 64,
    trainable feature encoder, dropout and SpecAugment off) on the card
    against the CPU: each step's loss and gradients, and every parameter
    after the second step within 1e-4. Adam moves an element by about lr
    a step whatever its gradient's size, so a gradient at roundoff level
    (the key projection's bias: softmax ignores a shift shared by a row)
    may step either way on either device; the gradients carry the check.
    The third item (27 frames, 30 labels) is infeasible: its loss is
    zeroed (``zero_infinity``) on both devices."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, conv_dim=(128,) * 7,
                      conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                      conv_stride=(5, 2, 2, 2, 2, 2, 2), vocab_size=46,
                      final_dropout=0.0, mask_time_prob=0.0, **NO_DROP)
    batch = pr_train_batch(cfg, b=3, seconds=2, seed=5,
                           lengths=[32_000, 21_000, 9_000])
    batch["phoneme_labels"][:, 30:] = -100  # frames 99, 65, 27
    lr, runs = 1e-5, {}
    for dev in ("cpu", "cuda"):
        model = random_w2v2_pr(cfg, seed=1)
        step = TrainStep(model, torch_adam(model), pr_loss_fn(), device=dev)
        steps = []
        for _ in range(2):
            loss = step(batch, lr)["loss"].item()
            steps.append((loss,) + flat_grads(model))
        runs[dev] = (steps, {n: p.detach().cpu()
                             for n, p in model.named_parameters()})
    (steps_c, pc), (steps_g, pg) = runs["cpu"], runs["cuda"]
    worst = max(pc, key=lambda n: (pg[n] - pc[n]).abs().max().item())
    err = (pg[worst] - pc[worst]).abs().max().item()
    log(f"  small f32 W2V2PR train steps, card vs CPU: losses "
        f"{[round(s[0], 6) for s in steps_g]} vs "
        f"{[round(s[0], 6) for s in steps_c]}; after two Adam steps (lr "
        f"{lr}) parameters max_abs_err {err:.2e} ({worst})")
    for i, ((lg, gg, fg), (lc, gc, fc)) in enumerate(zip(steps_g, steps_c)):
        if not (np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
            raise AssertionError(f"step {i + 1}: the card's loss disagrees "
                                 "with the CPU's")
        # float32 in both: only summation order and exp ulps differ
        compare_grads(f"small f32 W2V2PR step {i + 1} gradients, card vs "
                      f"CPU", gg, fg, gc, fc, max_rel=1e-4,
                      min_cos=0.99999999)
    if err > 1e-4:
        raise AssertionError("the card's W2V2PR parameters disagree with "
                             "the CPU's after two steps")


def time_ctc(batch, log_probs_shape, frame_lengths):
    """The CTC loss alone (forward and backward) on the step's shapes:
    wall ms (median of 5, synchronised), device ms and its kernel
    launches."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    lp = torch.randn(log_probs_shape, generator=gen).cuda()
    lp = lp.log_softmax(-1).requires_grad_()
    labels = torch.as_tensor(batch["phoneme_labels"]).cuda()
    target_lengths = (labels >= 0).sum(-1).to(torch.int32)
    targets = labels.clamp(min=0).to(torch.int32)

    def run():
        lp.grad = None
        ctc_loss(lp, frame_lengths, targets, target_lengths).backward()

    times = timed_batches(run, n=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels_ = device_kernels(prof)
    dev = sum(e.self_device_time_total for e in kernels_) / 1e3
    return (float(np.median(times)) * 1e3, dev,
            sum(e.count for e in kernels_))


def fe_backward_ms(model, audio):
    """The trainable feature extractor's backward alone at the step's
    shape: device ms of forward + backward less the forward's."""
    fe = model.wav2vec2.feature_extractor
    x = torch.as_tensor(audio).cuda().to(torch.bfloat16)
    with torch.no_grad():
        grad = torch.randn_like(fe(x))

    def fwd():
        with torch.no_grad():
            fe(x)

    def fwd_bwd():
        fe(x).backward(grad)

    fwd_ms = device_ms(fwd, iters=5)
    both_ms = device_ms(fwd_bwd, iters=5)
    model.zero_grad(set_to_none=True)
    return both_ms - fwd_ms, fwd_ms


def remat_step(cfg, remat, batch, loss_none):
    """One W2V2PR step under ``remat``, its launches, its loss against
    ``"none"``'s and its peak memory, then two more steps timed."""
    model = random_w2v2_pr(dataclasses.replace(cfg, remat_policy=remat),
                           seed=0)
    step = TrainStep(model, torch_adam(model), pr_loss_fn())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    counts = read_counts()
    times, _ = timed_steps(step, batch, 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.num_hidden_layers
    log(f"  remat_policy={remat!r}: first step loss {loss:.5f} (none: "
        f"{loss_none:.5f}), launches {counts}, steps 2-3 "
        f"{[round(t * 1e3, 2) for t in times]} ms, peak memory {peak:.2f} "
        f"GiB")
    if not (counts["flash_attn_fwd"] == 2 * layers
            and counts["flash_attn_bwd_dq"] == layers
            and counts["flash_attn_bwd_dkv"] == layers
            and counts["fused_conv_ln_gelu"] == 0
            and abs(loss - loss_none) <= 1e-3 * abs(loss_none)):
        raise AssertionError(f"the {remat!r} step took the wrong path or "
                             "loss")
    del step, model
    torch.cuda.empty_cache()
    return min(times) * 1e3, peak


def frozen_fused_step(cfg, batch):
    """A step of W2V2PR with the feature encoder frozen and the fused flag
    on (6 fused launches, the encoder bit-identical); then, dropout and
    SpecAugment off, a step from that encoder's output
    (``pr_loss_fn(from_features=True)``) against a step from the audio on
    the same weights."""
    cfg_fused = dataclasses.replace(cfg, fused_feature_extractor=True)
    model = random_w2v2_pr(cfg_fused, seed=0, freeze_feature_encoder=True)
    fe_prefix = "wav2vec2.feature_extractor."
    fe_before = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.startswith(fe_prefix)}
    step = TrainStep(model, torch_adam(model), pr_loss_fn())
    reset_counts()
    loss = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    counts = read_counts()
    fe_same = all(torch.equal(p.detach().cpu(), fe_before[n])
                  for n, p in model.named_parameters() if n in fe_before)
    layers = cfg.num_hidden_layers
    log(f"  frozen FE, fused_feature_extractor=True: first step loss "
        f"{loss:.5f}, launches {counts}, feature encoder bit-identical "
        f"{fe_same}")
    if not (np.isfinite(loss) and fe_same
            and counts["fused_conv_ln_gelu"] == 6
            and all(counts[n] == layers for n in FLASH)):
        raise AssertionError("the frozen-fused W2V2PR step took the wrong "
                             "path or moved the encoder")
    state = model.state_dict()
    del step, model
    torch.cuda.empty_cache()

    det = dataclasses.replace(cfg_fused, mask_time_prob=0.0,
                              final_dropout=0.0, **NO_DROP)
    losses = {}
    for from_features in (False, True):
        model = W2V2PR(det, freeze_feature_encoder=True)
        model.load_state_dict(state)
        data = dict(batch)
        if from_features:
            model.cuda()
            with torch.no_grad():
                data["fe_features"] = model.wav2vec2.feature_extractor(
                    torch.as_tensor(batch["audio"]).cuda().to(
                        torch.bfloat16))
        step = TrainStep(model, torch_adam(model),
                         pr_loss_fn(from_features=from_features))
        reset_counts()
        losses[from_features] = step(data, 1e-5)["loss"].item()
        counts_f = read_counts()
        del step, model, data
        torch.cuda.empty_cache()
    log(f"  train_from_features on the fused encoder's output (no dropout):"
        f" loss {losses[True]:.6f} vs the audio step's {losses[False]:.6f}; "
        f"launches {counts_f}")
    if not (abs(losses[True] - losses[False]) <= 1e-3 * abs(losses[False])
            and counts_f["fused_conv_ln_gelu"] == 0
            and all(counts_f[n] == layers for n in FLASH)):
        raise AssertionError("the step from features disagrees with the "
                             "step from audio")
    return counts


def check_validate_pr(model, cfg):
    """``validate_pr`` over two batches (8 x 5 s, then ragged 2-5 s)
    through ``make_eval_forward``, beam and greedy: the native library
    loads, every item goes through the C++ beam, the PER is finite."""
    if not native.native_available():
        raise AssertionError(f"the C++ beam did not build or load: "
                             f"{native.build_error()}")
    batches = [pr_train_batch(cfg, seed=11),
               pr_train_batch(cfg, seed=12, lengths=[
                   80_000, 32_000, 48_000, 64_000, 40_000, 56_000, 72_000,
                   36_000])]
    forward = make_eval_forward(model)
    n_items = sum(len(b["audio"]) for b in batches)
    results = {}
    for decode in ("beam", "greedy"):
        calls = native.beam_search_native.calls
        t0 = time.perf_counter()
        res = validate_pr(forward, batches, decode=decode)
        sec = time.perf_counter() - t0
        n_native = native.beam_search_native.calls - calls
        results[decode] = res
        log(f"  validate_pr decode={decode!r}: PER {res['mean_val_per']:.4f},"
            f" loss {res['mean_val_loss']:.4f}, {sec:.3f} s for {n_items} "
            f"items in 2 batches, native beam calls {n_native}")
        want = n_items if decode == "beam" else 0
        if not (np.isfinite(res["mean_val_per"])
                and np.isfinite(res["mean_val_loss"]) and n_native == want):
            raise AssertionError(f"validate_pr ({decode}) failed or fell "
                                 f"back to the Python beam")
    if not model.training:
        raise AssertionError("make_eval_forward left the model in eval()")
    return results


def phase_pr_train(card):
    log("== phase 5b: the W2V2PR train step at 8 x 5 s, trainable feature "
        "encoder")
    check_small_pr_train_reference()

    cfg = Wav2Vec2Config(dtype="bfloat16")
    batch = pr_train_batch(cfg)
    b, samples = batch["audio"].shape
    model = random_w2v2_pr(cfg, seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, torch_adam(model), pr_loss_fn())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0, counts = checked_first_step(step, batch, cfg.num_hidden_layers)
    layers = cfg.num_hidden_layers

    timed_steps(step, batch, 1)  # the second warm-up step
    reset_counts()
    times, m = timed_steps(step, batch, 5)
    counts5 = read_counts()
    sec = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = training_step_flops(b * pr_forward_flops(cfg, samples))
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  step times (s): {[round(x, 5) for x in times]}; launches over "
        f"them {counts5}; last loss {m['loss'].item():.5f}")
    log(f"  {b * samples / SAMPLE_RATE / sec:.1f} train audio-s/s, "
        f"{sec * 1e3:.2f} ms per step, MFU "
        f"{'not known for this card' if util is None else f'{util:.4f}'} "
        f"({flops / 1e12:.2f} TFLOP per step, 3x forward, the feature "
        f"encoder's backward included) on {card}; peak memory {peak:.2f} "
        f"GiB")
    if any(counts5[n] != 5 * layers for n in FLASH):
        raise AssertionError(f"launches over 5 steps: {counts5}")

    # the CTC loss in a profiler range of its own
    real_ctc = w2v2_pr.ctc_loss

    def ranged_ctc(*args, **kwargs):
        with torch.profiler.record_function("ctc_loss_forward"):
            return real_ctc(*args, **kwargs)

    w2v2_pr.ctc_loss = ranged_ctc
    try:
        busy, wall, prof = profile_breakdown(lambda: step(batch, 1e-5),
                                             "one W2V2PR train step",
                                             top=20)
    finally:
        w2v2_pr.ctc_loss = real_ctc
    rng_ev = [e for e in prof.key_averages() if e.key == "ctc_loss_forward"]
    if not rng_ev:
        raise AssertionError("the profiler saw no ctc_loss_forward range")
    rng_host = max(e.cpu_time_total for e in rng_ev) / 1e3
    rng_dev = max(e.device_time_total for e in rng_ev) / 1e3
    t = int(cfg.feat_extract_output_lengths(samples))
    frame_lengths = torch.full((b,), t, dtype=torch.int32).cuda()
    ctc_wall, ctc_dev, ctc_n = time_ctc(batch, (b, t, cfg.vocab_size),
                                        frame_lengths)
    ctc_share = ctc_wall / (sec * 1e3)
    log(f"  CTC loss: its forward's range in the profiled step "
        f"{rng_host:.2f} ms on the host, a {rng_dev:.2f} ms span on the "
        f"device; alone, "
        f"forward + backward {ctc_wall:.2f} ms wall ({ctc_share:.1%} of the "
        f"step's median), {ctc_dev:.2f} ms of kernels ({ctc_dev / busy:.1%} "
        f"of the profiled step's), {ctc_n} kernel launches")
    fe_bwd, fe_fwd = fe_backward_ms(model, batch["audio"])
    log(f"  feature encoder alone (7 conv layers, trainable): forward "
        f"{fe_fwd:.2f} ms, backward {fe_bwd:.2f} ms of kernels ("
        f"{fe_bwd / busy:.1%} of the profiled step's kernels)")

    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n].cpu())]
    n_fe = sum(1 for n in before if n.startswith("wav2vec2.feature_"
                                                 "extractor."))
    log(f"  after {step.step_count} steps: trainable tensors unchanged: "
        f"{unchanged} (of {len(before)}, {n_fe} in the feature encoder)")
    if unchanged or not n_fe:
        raise AssertionError("a trainable parameter did not move")
    del before

    validation = check_validate_pr(model, cfg)

    # the same batch, no dropout or SpecAugment, kernels vs plain attention
    model.eval()
    gk = grads_kernels_vs_plain(
        model, [torch.as_tensor(batch[k]).cuda() for k in (
            "audio", "audio_lengths", "phoneme_labels")], layers,
        "W2V2PR encoder gradients (FE included), kernels vs plain")
    n_fe_grads = sum(1 for n in gk if n.startswith("wav2vec2.feature_"))
    log(f"  {n_fe_grads} of them in the feature encoder")
    if not n_fe_grads:
        raise AssertionError("the feature encoder got no gradient")
    del gk, step, model
    torch.cuda.empty_cache()

    memory = {"none": (sec * 1e3, peak)}
    for remat in ("dots", "full"):
        memory[remat] = remat_step(cfg, remat, batch, loss0)
    log("  remat policies, ms a step and peak GiB: " + ", ".join(
        f"{k} {v[0]:.2f} ms / {v[1]:.2f} GiB" for k, v in memory.items()))
    counts_fused = frozen_fused_step(cfg, batch)
    return ({name: counts[name] for name in COUNTED},
            {name: counts_fused[name] for name in COUNTED}, validation)


# -- phase 6 ------------------------------------------------------------------

FORCE_INTS = ("pred_frame_phns", "pred_ctc_phn_seq", "phn_seq_lengths",
              "phn_seq_truncated", "frame_lengths")


def small_force_config():
    """A small float32 tower (head dim 64, the 7-layer conv stack) for the
    full-width FORCE head."""
    return tiny_config(hidden_size=128, num_attention_heads=2,
                       intermediate_size=256, conv_dim=(128,) * 7,
                       conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                       conv_stride=(5, 2, 2, 2, 2, 2, 2), vocab_size=46,
                       final_dropout=0.0, mask_time_prob=0.0, **NO_DROP)


def _force_rel_err(got, want, lens=None):
    """Largest |got − want| over the largest |want|; with ``lens``, over
    each item's first ``lens[b]`` columns of the last axis only (the
    alignment's valid phonemes)."""
    got, want = got.float().cpu(), want.float().cpu()
    if lens is not None:
        keep = (torch.arange(got.shape[-1])[None, :]
                < torch.as_tensor(lens).cpu()[:, None])[:, None, :]
        got, want = got * keep, want * keep
    return ((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30)).item()


def check_small_force_reference(device: str = "cuda"):
    """A small float32 ForceAPTAI on the card against the same weights on
    the CPU: ``predict`` and ``get_alignment``, TVs, hidden states and the
    alignment log-probs (valid phonemes) within 1e-4 of their largest
    magnitude, the integer outputs equal."""
    model = random_force_aptai(small_force_config(), seed=1).eval()
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((3, 32_000)) * 0.1).astype(np.float32)
    lens = np.array([32_000, 21_000, 9_000], np.int32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    runs = []
    for dev in ("cpu", device):
        m = copy.deepcopy(model).to(dev)
        args = [torch.from_numpy(a).to(dev) for a in (audio, lens)]
        with torch.no_grad():
            runs.append((m.predict(*args), m.get_alignment(*args)))
    (pc, ac), (pg, ag) = runs
    errs = {k: _force_rel_err(pg[k], pc[k]) for k in (
        "tvs_pred", "hidden_alignment", "hidden_tvs")}
    errs["alignment"] = _force_rel_err(ag["alignment"], ac["alignment"],
                                       ac["phn_seq_lengths"])
    same = {k: torch.equal(pg[k].cpu(), pc[k]) for k in FORCE_INTS}
    log(f"  small f32 ForceAPTAI, card vs CPU: relative errors "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; integer outputs "
        f"equal {same}; sequences of {pc['phn_seq_lengths'].tolist()} "
        f"tokens")
    # float32 in both: summation order, exp/tanh ulps, cuDNN's LSTM
    if not (all(v <= 1e-4 for v in errs.values()) and all(same.values())):
        raise AssertionError("the card's ForceAPTAI disagrees with the CPU's")


def check_force_result(res, n_samples, cfg):
    n = int(cfg.feat_extract_output_lengths(n_samples))
    s = int(res["phn_seq_lengths"])
    ok = (int(res["frame_lengths"]) == n and res["tvs_pred"].shape == (n, 9)
          and res["pred_frame_phns"].shape == (n,)
          and res["hidden_alignment"].shape == (n, 256)
          and res["hidden_tvs"].shape == (n, 512) and 0 <= s <= 60
          and all(np.isfinite(res[k]).all() for k in (
              "tvs_pred", "hidden_alignment", "hidden_tvs")))
    if not ok:
        raise AssertionError(f"bad FORCE result for a {n_samples}-sample "
                             f"request: frames {res['frame_lengths']}, tvs "
                             f"{res['tvs_pred'].shape}, tokens {s}")


def serve_requests(predict_batch, wavs, max_batch_size=8):
    """The requests through a ``MicroBatcher`` on its background thread
    (after one warm-up batch), with the kernel counts set to 0 just
    before: (results, batch sizes, counts, C++ beam calls, seconds)."""
    batches = []

    def serve(wavs, fields=None, real_rows=None):
        batches.append(len(wavs))
        return predict_batch(wavs, fields=fields, real_rows=real_rows)

    mb = MicroBatcher(serve, max_batch_size=max_batch_size, max_wait_ms=20.0)
    mb.warmup(seconds=10.0, cycles=1)
    batches.clear()
    reset_counts()
    calls = native.beam_search_native.calls
    mb.start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(w) for w in wavs]
        results = [f.result(timeout=600) for f in futs]
        sec = time.perf_counter() - t0
    finally:
        mb.stop()
    return (results, batches, read_counts(),
            native.beam_search_native.calls - calls, sec)


def force_kernel_vs_plain(pred, wavs):
    """The served batch's tower through the kernels and through plain
    attention, both heads fed the kernel run's decoded sequences: per-TV
    Pearson and alignment argmax agreement over the valid frames; and the
    decoded sequences of both (and of the plain tower on the waveforms
    scaled by 1 + 2^-9, the noise floor) for the sequence check."""
    from aptai_tpu_torch.infer.api import _prepare

    model = pred.model

    def run(scale=1.0, seqs=None):
        audio, lengths = _prepare([w * np.float32(scale) for w in wavs],
                                  "float32", pred.device)
        with torch.inference_mode():
            enc = model.encode_frozen(audio, lengths)
            decoded = model.decode(enc)
            head_in = (enc["frame_embs"], enc["frame_lengths"]) + tuple(
                decoded if seqs is None else seqs)
            out = model.predict_from_encoded(*head_in)
            out["alignment"] = model.alignment_from_encoded(
                *head_in)["alignment"]
        return decoded, out

    seq_k, out_k = run()
    w2v.multi_head_attention_bhtd = attention.flash_attention_bhtd_plain
    try:
        reset_counts()
        seq_p, out_p = run(seqs=seq_k)
        plain_counts = read_counts()
        seq_n, _ = run(scale=1 + 2 ** -9)
    finally:
        w2v.multi_head_attention_bhtd = attention.multi_head_attention_bhtd
    n = out_k["frame_lengths"].cpu()[:len(wavs)]
    valid = lambda x: torch.cat([x[b, :n[b]] for b in range(len(wavs))])
    tv_k = valid(out_k["tvs_pred"].cpu()).numpy()
    tv_p = valid(out_p["tvs_pred"].cpu()).numpy()
    rs = [pearson(tv_k[:, i], tv_p[:, i]) for i in range(9)]
    agree = (valid(out_k["alignment"].argmax(-1).cpu())
             == valid(out_p["alignment"].argmax(-1).cpu())).float().mean()

    def seqs(decoded):
        toks, lens = decoded[0].cpu(), decoded[1].cpu()
        return [toks[b, :lens[b]].tolist() for b in range(len(wavs))]

    return (rs, float(agree), seqs(seq_k), seqs(seq_p), seqs(seq_n),
            plain_counts)


def phase_force_serving(card):
    log("== phase 6: FORCE-APTAI serving")
    check_small_force_reference()
    cfg = Wav2Vec2Config(dtype="bfloat16")
    t0 = time.perf_counter()
    model = random_force_aptai(cfg, seed=0)
    pred = ForceAPTAIPredictor(model)
    log(f"  full-width FORCE-APTAI (bf16 tower, float32 head, seed 0) on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(8)
    seconds = (1.0, 10.0, 2.3, 4.7, 6.1, 7.9, 3.3, 8.6)
    wavs = [(rng.standard_normal(int(s * SAMPLE_RATE)) * 0.1).astype(
        np.float32) for s in seconds]
    layers = cfg.num_hidden_layers

    results, batches, counts, _, sec = serve_requests(pred.predict_batch,
                                                      wavs)
    for res, w in zip(results, wavs):
        check_force_result(res, len(w), cfg)
    log(f"  greedy: served {len(wavs)} requests ({sum(seconds):.1f} "
        f"audio-s) in {len(batches)} batch(es) of {batches} in {sec:.3f} s;"
        f" launches {counts}; tokens "
        f"{[int(r['phn_seq_lengths']) for r in results]}")
    nb = len(batches)
    if not (nb and counts["flash_attn_fwd"] == layers * nb
            and not counts["flash_attn_bwd_dq"]
            and not counts["flash_attn_bwd_dkv"]
            and not counts["fused_conv_ln_gelu"]):
        raise AssertionError(f"expected {layers} forward launches per "
                             f"batch and nothing else, got {counts} over "
                             f"{nb} batch(es)")
    serving = (counts, nb)

    rs, agree, seq_k, seq_p, seq_n, plain_counts = force_kernel_vs_plain(
        pred, wavs)
    ter, ter_n = compare_seqs(seq_k, seq_p), compare_seqs(seq_n, seq_p)
    log(f"  kernel vs plain attention, same batch and sequences: per-TV "
        f"Pearson min {min(rs):.6f}, alignment argmax agreement "
        f"{agree:.4%}; greedy sequences identical on "
        f"{sum(a == b for a, b in zip(seq_k, seq_p))} of {len(wavs)}, token"
        f" error rate {ter:.4%} (noise floor, plain on the waveforms x (1 + "
        f"2^-9): {sum(a == b for a, b in zip(seq_n, seq_p))} identical, "
        f"{ter_n:.4%})")
    # the TVs and the alignment held as phase 3 holds APTAI's; the decoded
    # sequences moved no more than the nudge moves them (one point slack)
    if (min(rs) < 0.999 or agree < 0.99 or any(plain_counts.values())
            or ter > ter_n + 0.01):
        raise AssertionError("FORCE through the kernel disagrees with the "
                             "plain attention beyond the noise floor")

    # beam_host through the split path: 6 requests in a batch of 8, so
    # the C++ beam runs for the real rows only
    beam_model = ForceAPTAI(cfg, decode_method="beam_host")
    beam_model.load_state_dict(model.state_dict())
    beam_pred = ForceAPTAIPredictor(beam_model)
    del beam_model
    if not native.native_available():
        raise AssertionError(f"the C++ beam did not build or load: "
                             f"{native.build_error()}")
    results_b, batches_b, counts_b, n_native, sec_b = serve_requests(
        beam_pred.predict_batch, wavs[:6])
    for res, w in zip(results_b, wavs[:6]):
        check_force_result(res, len(w), cfg)
    greedy_seqs = [r["pred_ctc_phn_seq"][:int(r["phn_seq_lengths"])].tolist()
                   for r in results[:6]]
    beam_seqs = [r["pred_ctc_phn_seq"][:int(r["phn_seq_lengths"])].tolist()
                 for r in results_b]
    log(f"  beam_host (split): served 6 requests in batch(es) of "
        f"{batches_b} (8 rows each) in {sec_b:.3f} s, native beam calls "
        f"{n_native}, launches {counts_b}; beam vs greedy token error rate "
        f"{compare_seqs(beam_seqs, greedy_seqs):.4%}")
    if not (n_native == 6
            and counts_b["flash_attn_fwd"] == layers * len(batches_b)):
        raise AssertionError(f"the beam_host predictor decoded "
                             f"{n_native} rows for 6 requests")
    del beam_pred

    cfg_fused = dataclasses.replace(cfg, fused_feature_extractor=True)
    fused_model = ForceAPTAI(cfg_fused)
    fused_model.load_state_dict(model.state_dict())
    fused_pred = ForceAPTAIPredictor(fused_model)
    del fused_model
    results_f, batches_f, counts_f, _, _ = serve_requests(
        fused_pred.predict_batch, wavs)
    for res, w in zip(results_f, wavs):
        check_force_result(res, len(w), cfg)
    nf = len(batches_f)
    log(f"  fused_feature_extractor=True: {nf} batch(es), launches "
        f"{counts_f}")
    if not (nf and counts_f["fused_conv_ln_gelu"] == 6 * nf
            and counts_f["flash_attn_fwd"] == layers * nf
            and not counts_f["flash_attn_bwd_dq"]
            and not counts_f["flash_attn_bwd_dkv"]):
        raise AssertionError(f"expected 6 fused and {layers} forward "
                             f"launches per batch, got {counts_f}")
    del fused_pred
    torch.cuda.empty_cache()

    log("  predict_batch at 32 x 10 s, greedy")
    rng = np.random.default_rng(9)
    big = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
           for _ in range(32)]
    times = timed_batches(lambda: pred.predict_batch(big))
    sec = float(np.median(times))
    flops = 32 * pr_forward_flops(cfg, 10 * SAMPLE_RATE)
    util = mfu(flops, sec, device_peak_tflops())
    log(f"  batch times (s): {[round(x, 5) for x in times]}")
    log(f"  {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms per batch, "
        f"MFU {'not known for this card' if util is None else f'{util:.4f}'}"
        f" ({flops / 1e12:.2f} TFLOP per batch, the tower's; the head is "
        f"not counted) on {card}")
    profile_breakdown(lambda: pred.predict_batch(big), "one FORCE batch")
    del pred, model
    torch.cuda.empty_cache()
    return serving, (counts_f, nf)


def compare_seqs(a, b):
    """Token error rate of sequences ``a`` against ``b``."""
    return (sum(edit_distance(x, y) for x, y in zip(a, b))
            / max(sum(len(y) for y in b), 1))


# -- phase 6b -----------------------------------------------------------------

def force_train_batch(cfg, b: int = 8, seconds: int = 5, seed: int = 0,
                      lengths=None):
    """The train batch's audio (``train_batch``; ``lengths`` in samples
    silences each item past its length) with TV targets padded past each
    item's frames, frame phonemes and 40-70 phoneme labels: the keys of
    the FORCE adapter and of ``validate_tv`` / ``ctc_seq_per``."""
    batch = pr_train_batch(cfg, b, seconds, seed, lengths)
    base = train_batch(cfg, b, seconds, seed)
    frames = cfg.feat_extract_output_lengths(batch["audio_lengths"])
    tv, phn = base["tv_targets"], base["phn_frames"]
    for i, n in enumerate(frames):
        tv[i, n:] = -100.0
        phn[i, n:] = 0
    batch.update(tv_targets=tv, phn_frames=phn,
                 frame_lengths=frames.astype(np.int32))
    return batch


def check_small_force_train_reference(device: str = "cuda"):
    """Two Adam steps (lr 1e-5) of a small float32 ForceAPTAI from audio
    (head dropout off) on the card against the CPU: each step's loss and
    head gradients, and every parameter after the second step within
    1e-4; the tower untouched on both."""
    cfg = small_force_config()
    batch = force_train_batch(cfg, b=3, seconds=2, seed=5,
                              lengths=[32_000, 21_000, 9_000])
    lr, runs = 1e-5, []
    for dev in ("cpu", device):
        model = random_force_aptai(cfg, seed=1, hidden_drop=0.0,
                                   rnn_drop=0.0)
        step = TrainStep(model, torch_adam(model), force_loss_fn(),
                         device=dev)
        steps = []
        for _ in range(2):
            loss = step(batch, lr)["loss"].item()
            steps.append((loss,) + flat_grads(model))
        runs.append((steps, {n: p.detach().cpu()
                             for n, p in model.named_parameters()}))
    (steps_c, pc), (steps_g, pg) = runs
    worst = max(pc, key=lambda n: (pg[n] - pc[n]).abs().max().item())
    err = (pg[worst] - pc[worst]).abs().max().item()
    log(f"  small f32 ForceAPTAI train steps, card vs CPU: losses "
        f"{[round(s[0], 6) for s in steps_g]} vs "
        f"{[round(s[0], 6) for s in steps_c]}; after two Adam steps (lr "
        f"{lr}) parameters max_abs_err {err:.2e} ({worst})")
    for i, ((lg, gg, fg), (lc, gc, fc)) in enumerate(zip(steps_g, steps_c)):
        if not (np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
            raise AssertionError(f"step {i + 1}: the card's FORCE loss "
                                 "disagrees with the CPU's")
        if any(n.startswith("w2v2_pr.") for n in gg):
            raise AssertionError("a gradient reached the frozen tower")
        compare_grads(f"small f32 FORCE step {i + 1} head gradients, card "
                      f"vs CPU", gg, fg, gc, fc, max_rel=1e-4,
                      min_cos=0.99999999)
    if err > 1e-4:
        raise AssertionError("the card's FORCE parameters disagree with "
                             "the CPU's after two steps")


def time_forward_sum(log_probs_shape, text_lengths, mel_lengths):
    """ForwardSum alone (forward and backward) on the step's shapes: wall
    ms (median of 5, synchronised), device ms and its kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    att = torch.randn(log_probs_shape, generator=gen).cuda()
    att = att.log_softmax(-1).requires_grad_()
    text, mel = text_lengths.cuda(), mel_lengths.cuda()

    def run():
        att.grad = None
        forward_sum_loss(att, text, mel).backward()

    times = timed_batches(run, n=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels_ = device_kernels(prof)
    dev = sum(e.self_device_time_total for e in kernels_) / 1e3
    return (float(np.median(times)) * 1e3, dev,
            sum(e.count for e in kernels_))


def force_steps(step, batch, what, card, n=3):
    """``n`` timed steps after one warm-up step, then one profiled step:
    step ms, device idle and peak memory (reset before the warm-up)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed_steps(step, batch, 1)
    times, m = timed_steps(step, batch, n)
    sec = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, wall, _ = profile_breakdown(lambda: step(batch, 1e-5),
                                      f"one FORCE step {what}", top=10)
    log(f"  {what}: step times (s) {[round(x, 5) for x in times]}, "
        f"median {sec * 1e3:.2f} ms; last loss {m['loss'].item():.5f}; "
        f"peak memory {peak:.2f} GiB; profiled step {busy:.2f} ms of "
        f"kernels in {wall:.2f} ms (device idle {1 - busy / wall:.1%}) on "
        f"{card}")
    return sec * 1e3, peak


def phase_force_train(card):
    log("== phase 6b: the FORCE head train step at 8 x 5 s, frozen tower")
    check_small_force_train_reference()

    cfg = Wav2Vec2Config(dtype="bfloat16")
    batch = force_train_batch(cfg)
    model = random_force_aptai(cfg, seed=0)
    tower = {n: p.detach().clone() for n, p in
             model.w2v2_pr.named_parameters()}
    head = {n: p.detach().clone() for n, p in model.named_parameters()
            if not n.startswith("w2v2_pr.")}
    opt = torch_adam(model)
    step = TrainStep(model, opt, force_loss_fn())
    layers = cfg.num_hidden_layers
    torch.cuda.synchronize()
    reset_counts()
    loss0 = step(batch, 1e-5)["loss"].item()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  first step from audio (dropout on): loss {loss0:.5f}, launches "
        f"{counts}")
    if not (np.isfinite(loss0) and counts["flash_attn_fwd"] == layers
            and not counts["flash_attn_bwd_dq"]
            and not counts["flash_attn_bwd_dkv"]
            and not counts["fused_conv_ln_gelu"]):
        raise AssertionError(f"expected {layers} forward launches and no "
                             f"backward ones a step, got {counts}")
    names = {id(p): n for n, p in model.named_parameters()}
    state = sorted(names[id(p)] for p in opt.state)
    if state != sorted(head):
        raise AssertionError(f"Adam holds state for {len(state)} tensors, "
                             f"not the head's {len(head)}")
    audio_ms, audio_peak = force_steps(step, batch, "from audio", card)

    t0 = time.perf_counter()
    cached = collate_encoded(encode_items([batch], model))
    log(f"  the tower once over the batch (encode_items + collate_encoded):"
        f" {(time.perf_counter() - t0) * 1e3:.1f} ms; frame_embs "
        f"{cached['frame_embs'].shape}, tokens "
        f"{cached['phn_seq_lengths'].tolist()}")
    step_c = TrainStep(model, opt, force_loss_fn(from_encoded=True))
    reset_counts()
    cache_ms, cache_peak = force_steps(step_c, cached, "from the cache",
                                       card)
    if any(read_counts().values()):
        raise AssertionError("a step from the cache launched a tower kernel")

    b, t = len(batch["audio"]), int(cached["enc_frame_lengths"].max())
    fs_wall, fs_dev, fs_n = time_forward_sum(
        (b, t, 60), torch.as_tensor(cached["phn_seq_lengths"]),
        torch.as_tensor(cached["enc_frame_lengths"]))
    log(f"  ForwardSum alone at ({b}, {t}, 60), forward + backward: "
        f"{fs_wall:.2f} ms wall ({fs_wall / cache_ms:.1%} of the cached "
        f"step's median, {fs_wall / audio_ms:.1%} of the audio step's), "
        f"{fs_dev:.2f} ms of kernels, {fs_n} kernel launches")

    same = all(torch.equal(p.cpu(), tower[n])
               for n, p in model.w2v2_pr.named_parameters())
    unchanged = [n for n, p in model.named_parameters()
                 if n in head and torch.equal(p.detach().cpu(), head[n])]
    log(f"  after {step.step_count + step_c.step_count} steps: tower "
        f"bit-identical {same}; head tensors unchanged {unchanged} (of "
        f"{len(head)}); peak memory from audio {audio_peak:.2f} GiB, from "
        f"the cache {cache_peak:.2f} GiB")
    if not same or unchanged:
        raise AssertionError("the tower moved or a head tensor did not")

    batches = [force_train_batch(cfg, seed=11),
               force_train_batch(cfg, seed=12, lengths=[
                   80_000, 32_000, 48_000, 64_000, 40_000, 56_000, 72_000,
                   36_000])]
    forward = force_eval_forward(model)
    t0 = time.perf_counter()
    per = ctc_seq_per(forward, batches)
    tv = validate_tv(forward, batches)
    sec = time.perf_counter() - t0
    log(f"  make_eval_forward over 2 batches: ctc_seq_per {per:.4f}, "
        f"validate_tv loss {tv['val_mean_loss']:.4f}, pcc "
        f"{tv['val_mean_pcc']:.4f}, FER {tv['val_mean_FER']:.4f} in "
        f"{sec:.3f} s")
    if not (np.isfinite(per) and all(np.isfinite(v) for v in tv.values())
            and model.training):
        raise AssertionError("the FORCE evaluation failed")
    del step, step_c, opt, model
    torch.cuda.empty_cache()
    return {name: counts[name] for name in COUNTED}


# -- phase 7 ------------------------------------------------------------------

def _lp(logits):
    return torch.log_softmax(torch.as_tensor(logits, dtype=torch.float32),
                             dim=-1)


def small_beam_cases():
    """(name, log-probs (B, T, V), lengths, cap): CTC-like posteriors
    (blank-dominated, bursts of emissions) at V 46 and FORCE's cap 60;
    uniform rows, where every live candidate of a parent ties; and rows
    with two tokens tied on every frame."""
    rng = np.random.default_rng(30)
    b, t = 8, 200
    logits = rng.standard_normal((b, t, 46)).astype(np.float32)
    logits[..., 0] += 6.0
    for i in range(b):
        n = rng.integers(20, 45)
        logits[i, np.sort(rng.choice(t, n, replace=False)),
               rng.integers(1, 46, n)] += 10.0
    lens = torch.from_numpy(rng.integers(t // 4, t + 1, b).astype(np.int32))
    paired = rng.standard_normal((4, 60, 9)).astype(np.float32)
    top = rng.integers(1, 8, (4, 60))
    for i in range(4):
        paired[i, np.arange(60), top[i]] = 4.0
        paired[i, np.arange(60), top[i] + 1] = 4.0
    tied_lens = torch.tensor([60, 41, 0, 23], dtype=torch.int32)
    return [("CTC-like", _lp(logits), lens, 60),
            ("uniform", _lp(np.zeros((4, 60, 9))), tied_lens, None),
            ("two tied tokens", _lp(paired), tied_lens, None)]


def check_small_data_ops():
    """Float32 on the card against the CPU: the device beam exact on
    peaked and tied posteriors (with times), and against the C++ beam on
    the peaked ones; ``viterbi_align`` exact; the signal ops within 1e-4
    of the CPU's largest magnitude (cuFFT and cuBLAS against the CPU's
    summation orders)."""
    for name, lp, lens, cap in small_beam_cases():
        runs = [beam_decode_device(x, n, max_output_length=cap,
                                   return_times=True)
                for x, n in ((lp, lens), (lp.cuda(), lens.cuda()))]
        same = all(torch.equal(c, g.cpu()) for c, g in zip(*runs))
        native_same = None
        if cap is not None:
            host = beam_decode_padded(lp, lens, cap)
            native_same = all(np.array_equal(h, c.numpy())
                              for h, c in zip(host, runs[0][:3]))
        log(f"  device beam, {name} {tuple(lp.shape)}: card equal to CPU "
            f"{same}, to the C++ beam {native_same}; tokens "
            f"{runs[1][1].tolist()}")
        if not same or native_same is False:
            raise AssertionError(f"the device beam disagrees ({name})")

    rng = np.random.default_rng(31)
    scores = torch.from_numpy(rng.standard_normal((4, 120, 30)).astype(
        np.float32))
    text = torch.tensor([30, 17, 1, 24])
    frames = torch.tensor([120, 64, 9, 24])
    paths = [viterbi_align(scores, text, frames),
             viterbi_align(scores.cuda(), text.cuda(), frames.cuda())]
    same = torch.equal(paths[0], paths[1].cpu())
    log(f"  viterbi_align (4, 120, 30): card equal to CPU {same}")
    if not same:
        raise AssertionError("viterbi_align disagrees on the card")

    wav = torch.from_numpy((rng.standard_normal((2, 44_100)) * 0.1).astype(
        np.float32))
    ops = {"stft_magnitude": signal.stft_magnitude,
           "melspectrogram": signal.melspectrogram, "mfcc": signal.mfcc,
           "resample 44.1 -> 16 kHz": lambda x: signal.resample(
               x, 44_100, 16_000)}
    errs = {}
    for name, op in ops.items():
        want, got = op(wav), op(wav.cuda()).cpu()
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
    log(f"  signal ops, card vs CPU, relative errors "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    if max(errs.values()) > 1e-4:
        raise AssertionError("a signal op disagrees on the card")


def synthetic_corpus(root):
    """``make_synthetic_hprc`` on the card (2 utterances a speaker, 4
    speakers, both rates) → ``loso_split`` (test speaker M04, both rates)
    → the training fold's ``BucketedLoader(collate_tv)`` of 4, read once
    through ``PrefetchLoader``: (rows, vocab, train rows, the loader)."""
    t0 = time.perf_counter()
    rows = read_rows(make_synthetic_hprc(root, 2, HPRC_SPEAKERS[:4]))
    made = time.perf_counter() - t0
    vocab = build_vocab(r["phoneme_labels"] for r in rows)
    train, valid, test_n, test_f = loso_split(rows, "M04", "both")
    loader = BucketedLoader(HPRCDataset(train, vocab, "both"), 4, collate_tv)
    t0 = time.perf_counter()
    batches = list(PrefetchLoader(loader))
    read = time.perf_counter() - t0
    cfg = Wav2Vec2Config()
    ok = bool(batches)
    for b in batches:
        frames = cfg.feat_extract_output_lengths(b["audio_lengths"])
        ok &= (b["audio"].shape[0] == 4 and b["audio"].shape[1] % 16_000 == 0
               and b["batch_pad_mask"][0]
               and np.array_equal(b["frame_lengths"], frames)
               and b["tv_targets"].shape[1] % 64 == 0)
    log(f"  synthetic HPRC corpus: {len(rows)} utterances in {made:.2f} s "
        f"(mspec and MFCC on the card); LOSO M04: train {len(train)}, "
        f"valid {len(valid)}, test N {len(test_n)} / F {len(test_f)}; "
        f"{len(batches)} train batches of 4 (real rows "
        f"{[int(b['batch_pad_mask'].sum()) for b in batches]}, audio widths "
        f"{[b['audio'].shape[1] for b in batches]}) read in {read:.3f} s")
    if not (ok and len(train) and len(valid) and len(test_n) == 2):
        raise AssertionError("the synthetic corpus or its loader is wrong")
    return rows, vocab, train, loader


def phase_fe_cache(loader, card):
    """Full-width bf16 APTAI (seed 0, FE frozen and fused) through
    ``FECachedLoader``, then three steps from the cache and one batch's
    step from the cache against its step from audio."""
    cfg = dataclasses.replace(Wav2Vec2Config(dtype="bfloat16"),
                              fused_feature_extractor=True)
    model = random_aptai(cfg, seed=0).cuda()
    layers = cfg.num_hidden_layers
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cache = FECachedLoader(loader, model, seed=0)
    torch.cuda.synchronize()
    pass_ms = (time.perf_counter() - t0) * 1e3
    pass_counts = read_counts()
    n = len(loader)
    log(f"  FECachedLoader over {n} batches: {len(cache.dataset)} "
        f"utterances, {cache.cache_bytes / 2**20:.2f} MiB in "
        f"{pass_ms:.1f} ms; launches {pass_counts}")
    if not (pass_counts["fused_conv_ln_gelu"] == 6 * n
            and not any(pass_counts[k] for k in FLASH)):
        raise AssertionError("expected 6 fused launches a batch and no "
                             "other in the cache pass")

    trained = copy.deepcopy(model)
    step = TrainStep(trained, torch_adam(trained), aptai_loss_fn(True))
    batches = list(PrefetchLoader(cache))
    losses, step_counts = [], None
    for i in range(3):
        torch.cuda.synchronize()
        reset_counts()
        losses.append(step(batches[i % len(batches)], 1e-5)["loss"].item())
        torch.cuda.synchronize()
        step_counts = step_counts or read_counts()
    log(f"  three steps from the cache (fe_features "
        f"{[b['fe_features'].shape for b in batches][:3]}): losses "
        f"{[round(x, 5) for x in losses]}; first step's launches "
        f"{step_counts}")
    if not (all(np.isfinite(losses)) and not step_counts["fused_conv_ln_gelu"]
            and all(step_counts[k] == layers for k in FLASH)):
        raise AssertionError(f"expected {layers} launches of each flash "
                             f"kernel and finite losses, got {step_counts}")

    # one batch, unbucketed on both sides so the frame widths agree
    items = [loader.dataset[i] for i in range(4)]
    audio_batch = collate_tv(items, bucket=False)

    class OneBatch(list):
        batch_size = 4

    fe_batch = collate_fe(FECachedLoader(OneBatch([audio_batch]), model,
                                         shuffle=False).dataset.items,
                          bucket=False)
    pair = []
    for from_fe, b in ((False, audio_batch), (True, fe_batch)):
        m = copy.deepcopy(model)
        pair.append(TrainStep(m, torch_adam(m), aptai_loss_fn(from_fe))(
            b, 1e-5)["loss"].item())
        del m
    rel = abs(pair[1] - pair[0]) / abs(pair[0])
    log(f"  one batch's step from audio vs from the cache (same weights, "
        f"seed, pad width): loss {pair[0]:.6f} vs {pair[1]:.6f} (relative "
        f"difference {rel:.2e}) on {card}")
    # the same operations after the extractor; 1e-5 leaves room for
    # cuBLAS choosing another algorithm
    if not rel <= 1e-5:
        raise AssertionError("the step from the cache disagrees with the "
                             "step from audio")
    del step, trained, model, cache
    torch.cuda.empty_cache()
    return (pass_counts, n), step_counts


def phase_force_cache(rows, vocab, train, loader):
    """Full-width FORCE-APTAI (bf16 tower, float32 head, seed 0) with
    ``decode_method="beam_device"``: ``FrozenEncodedLoader`` over the
    training fold, ``FrozenEncodedCorpus`` over the manifest and its
    ``loader_for`` the fold, two head steps from the fold's cache. Returns
    the pass's launch counts and batch count, and the model."""
    cfg = Wav2Vec2Config(dtype="bfloat16")
    model = random_force_aptai(cfg, seed=0,
                               decode_method="beam_device").cuda()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fold = FrozenEncodedLoader(loader, model, seed=0)
    torch.cuda.synchronize()
    pass_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    n = len(loader)
    t0 = time.perf_counter()
    corpus = FrozenEncodedCorpus(rows, vocab, model, batch_size=4)
    corpus_ms = (time.perf_counter() - t0) * 1e3
    fold_c = corpus.loader_for(train, 4, seed=0)
    tokens = [it["phn_seq_length"] for it in fold.dataset.items]
    log(f"  FrozenEncodedLoader (beam_device) over {n} batches: "
        f"{len(fold.dataset)} utterances, {fold.cache_bytes / 2**20:.2f} "
        f"MiB in {pass_ms:.1f} ms, tokens {tokens}; launches {counts}; "
        f"FrozenEncodedCorpus over {len(corpus)} utterances in "
        f"{corpus_ms:.1f} ms ({corpus.cache_bytes / 2**20:.2f} MiB), "
        f"loader_for the fold: {len(fold_c.dataset)} items")
    layers = cfg.num_hidden_layers
    if not (counts["flash_attn_fwd"] == layers * n
            and not counts["fused_conv_ln_gelu"]
            and not counts["flash_attn_bwd_dq"]
            and len(fold_c.dataset) == len(fold.dataset) == len(train)
            and len(corpus) == len(rows) and max(tokens) > 0):
        raise AssertionError("the FORCE cache pass is wrong")

    step = TrainStep(model, torch_adam(model),
                     force_loss_fn(from_encoded=True))
    reset_counts()
    losses = [step(b, 1e-5)["loss"].item() for b, _ in zip(fold_c, range(2))]
    torch.cuda.synchronize()
    log(f"  two head steps from loader_for's batches: losses "
        f"{[round(x, 5) for x in losses]}, launches {read_counts()}")
    if not all(np.isfinite(losses)) or any(read_counts().values()):
        raise AssertionError("a head step from the cache failed")
    model.eval()
    return (counts, n), model


def phase_beam_serving(model, card):
    """FORCE ``predict_batch`` at 32 x 10 s with ``beam_device`` beside
    greedy (the same predictor, the decode switched); the beam alone at
    FORCE's cap of 60 (wall ms, kernel launches) and the C++ beam over the
    same 32 rows. The sequences are compared uncapped: past the cap the
    device beam's scores are exact no longer (the JAX package's capacity
    semantics), and random weights emit far more than 60 tokens in 10 s."""
    from torch.profiler import ProfilerActivity, profile

    pred = ForceAPTAIPredictor(model)
    rng = np.random.default_rng(9)
    big = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
           for _ in range(32)]
    rates = {}
    for method, n in (("greedy", 5), ("beam_device", 3), ("greedy", 5)):
        pred.model.decode_method = method
        times = timed_batches(lambda: pred.predict_batch(big), n=n,
                              warmup=1)
        rates.setdefault(method, []).append(320 / float(np.median(times)))
    log(f"  predict_batch at 32 x 10 s: greedy "
        f"{[round(r, 1) for r in rates['greedy']]} audio-s/s (before, "
        f"after), beam_device {rates['beam_device'][0]:.1f} audio-s/s on "
        f"{card}")

    def log_probs(scale=1.0):
        audio, lengths = _prepare([w * np.float32(scale) for w in big],
                                  "float32", pred.device)
        with torch.inference_mode():
            enc = pred.model.encode_frozen(audio, lengths)
        return enc["ctc_log_probs"], enc["frame_lengths"]

    lp, fl = log_probs()
    t_max = lp.shape[1]

    def beam():
        return beam_decode_device(lp, fl, max_output_length=60)

    times = timed_batches(beam, n=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        capped = beam()
        torch.cuda.synchronize()
    kernels_ = device_kernels(prof)
    launches = sum(e.count for e in kernels_)
    dev_ms = sum(e.self_device_time_total for e in kernels_) / 1e3
    t0 = time.perf_counter()
    host = beam_decode_padded(lp, fl, t_max)
    host_ms = (time.perf_counter() - t0) * 1e3
    beam_ms = float(np.median(times)) * 1e3
    log(f"  the device beam alone over {tuple(lp.shape)}, cap 60: "
        f"{beam_ms:.1f} ms wall (median of 3), {launches} kernel launches "
        f"({launches / t_max:.1f} a frame), {dev_ms:.2f} ms of kernels; "
        f"the C++ beam over the same 32 rows {host_ms:.1f} ms")

    def seqs(out):
        return [out[0][b, :out[1][b]].tolist() for b in range(32)]

    want = seqs(host)
    got = seqs(beam_decode_device(lp, fl))
    same = sum(a == b for a, b in zip(got, want))
    capped_same = sum(a == b[:60] for a, b in zip(seqs(capped), want))
    log(f"  uncapped, device beam vs C++ beam on the same log-probs: {same} "
        f"of 32 identical ({sum(map(len, want))} tokens); at cap 60 "
        f"{capped_same} of 32 equal the C++ beam's first 60 tokens")
    if got != want:
        # float32 against float64 scores may split a near-tie: hold the
        # split to the noise floor of a (1 + 2^-9) nudge of the waveforms,
        # as phase 6 holds the greedy sequences
        floor = seqs(beam_decode_padded(*log_probs(1 + 2 ** -9), t_max))
        ter, ter_n = compare_seqs(got, want), compare_seqs(floor, want)
        log(f"  token error rate {ter:.4%} (noise floor {ter_n:.4%}, "
            f"{sum(a == b for a, b in zip(floor, want))} of 32 identical)")
        if ter > ter_n + 0.01:
            raise AssertionError("the device beam disagrees with the C++ "
                                 "beam beyond the noise floor")
    del pred
    torch.cuda.empty_cache()


def check_validate_pr_beam_device(model, card):
    """``validate_pr`` on the FORCE tower (full-width W2V2PR) over two
    batches (8 x 5 s, ragged 2-5 s), ``"beam"`` beside ``"beam_device"``."""
    cfg = model.cfg
    batches = [pr_train_batch(cfg, seed=11),
               pr_train_batch(cfg, seed=12, lengths=[
                   80_000, 32_000, 48_000, 64_000, 40_000, 56_000, 72_000,
                   36_000])]
    forward = make_eval_forward(model.w2v2_pr)
    res = {}
    for decode in ("beam", "beam_device"):
        t0 = time.perf_counter()
        res[decode] = validate_pr(forward, batches, decode=decode)
        log(f"  validate_pr decode={decode!r} on the FORCE tower (full-width"
            f" W2V2PR): PER {res[decode]['mean_val_per']:.4f}, loss "
            f"{res[decode]['mean_val_loss']:.4f} in "
            f"{time.perf_counter() - t0:.3f} s on {card}")
    # the same forward, so the same loss (1e-5: cuBLAS may pick another
    # algorithm); the PER within one point (float32 against float64 beam
    # scores)
    a, b = res["beam"], res["beam_device"]
    if not (abs(a["mean_val_loss"] - b["mean_val_loss"])
            <= 1e-5 * abs(a["mean_val_loss"])
            and np.isfinite(b["mean_val_per"])
            and abs(a["mean_val_per"] - b["mean_val_per"]) <= 0.01):
        raise AssertionError("validate_pr with the device beam disagrees")


def phase_data(card):
    log("== phase 7: the data layer and the device beam")
    t_phase = time.perf_counter()
    check_small_data_ops()
    with tempfile.TemporaryDirectory() as tmp:
        rows, vocab, train, loader = synthetic_corpus(tmp)
        fe_pass, fe_step = phase_fe_cache(loader, card)
        force_pass, model = phase_force_cache(rows, vocab, train, loader)
    phase_beam_serving(model, card)
    check_validate_pr_beam_device(model, card)
    del model
    torch.cuda.empty_cache()
    log(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return fe_pass, fe_step, force_pass

# -- phase 8 ------------------------------------------------------------------

# the trainers' device (their --platform); "auto" is the card
PLATFORM = "auto"


class _Epochs:
    """A trainer's training loader as ``fit`` reads it: per epoch the launch
    counts around its steps (set to 0 when the epoch's first batch is asked
    for, read when the last one is done with), the first epoch's batches,
    and a SIGTERM to this process from the main thread before batch ``i``
    of epoch ``e`` when ``sigterm_at=(e, i)``."""

    def __init__(self, loader, rec, sigterm_at=None):
        self.loader, self.rec, self.sigterm_at = loader, rec, sigterm_at

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        epoch = len(self.rec["epochs"])
        reset_counts()
        try:
            for i, batch in enumerate(self.loader):
                if self.sigterm_at == (epoch, i):
                    os.kill(os.getpid(), SIGTERM)
                if epoch == 0:
                    self.rec["batches"].append(batch)
                yield batch
        finally:
            self.rec["epochs"].append(read_counts())


class FitProbe:
    """Within ``with FitProbe(module)``, the trainer module's ``fit`` runs
    with its engine built here (``make_engine``, as ``fit`` builds it) and
    its loader read through :class:`_Epochs`; each call leaves a record:
    the model, checkpoint manager, engine, per-epoch launch counts, the
    first epoch's batches, the history (when it returned), the decode
    method, and on a resume the restored state against the files."""

    def __init__(self, module, sigterm_at=None, expect=None):
        self.module, self.sigterm_at = module, sigterm_at
        self.expect = expect
        self.calls = []

    def __enter__(self):
        self.real = self.module.fit
        self.module.fit = self._fit
        return self

    def __exit__(self, *exc):
        self.module.fit = self.real
        return False

    def _fit(self, cfg, loss_fn, model, train_loader, validate_fn, ckpt,
             frozen_prefixes=(), **kw):
        engine = make_engine(cfg, loss_fn, model, frozen_prefixes)
        rec = {"model": model, "ckpt": ckpt, "engine": engine, "epochs": [],
               "batches": [], "decode_method": getattr(
                   model, "decode_method", None)}
        self.calls.append(rec)

        def log_fn(msg):
            log(f"    fit: {msg}")
            if msg.startswith("resumed from epoch"):
                rec["resume"] = restored_state_check(engine, ckpt.last_dir,
                                                     self.expect)

        loader = _Epochs(train_loader, rec, self.sigterm_at)
        try:
            _, rec["history"] = self.real(cfg, loss_fn, model, loader,
                                          validate_fn, ckpt, engine=engine,
                                          log_fn=log_fn, **kw)
        except Preempted:
            rec["at_exit"] = host_state(engine)
            raise
        best = ckpt.best_dir / "params.msgpack"
        rec["best_has_tower"] = (isinstance(model, ForceAPTAI)
                                 and "w2v2_pr" in flax_keys(best))
        return model, rec["history"]


def mapped_flax(path):
    """The tree of a flax msgpack file, its arrays views of the file
    mapped into memory (read only where they are read)."""
    with open(path, "rb") as f:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return msgpack_restore(data)


def flax_keys(path) -> set:
    """The top-level keys of a ``params.msgpack``; its arrays are not
    read."""
    return set(mapped_flax(path))


def host_copy(tensors) -> dict:
    """A copy on the host of a dict of tensors (``to_host`` leaves a CPU
    tensor as it is)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def host_state(engine) -> dict:
    """The engine's step counter, Adam state (by name) and parameters,
    copied to the host."""
    adam = JaxAdamState.from_optimizer(engine.optimizer, engine.model)
    return {"step": engine.step_count, "adam": dataclasses.replace(
        adam, exp_avg=host_copy(adam.exp_avg),
        exp_avg_sq=host_copy(adam.exp_avg_sq)),
        "params": host_copy(engine.model.state_dict())}


def same_adam(live: JaxAdamState, want: JaxAdamState) -> bool:
    """One count, and each of ``want``'s moments bit for bit in ``live``;
    ``live``'s others zero (the JAX package's moments of a parameter this
    package never stepped, as a resume from its files loads them)."""
    def same(k, m, v):
        if k not in want.exp_avg:
            return not (m.any() or v.any())
        return (torch.equal(m.cpu(), want.exp_avg[k].cpu())
                and torch.equal(v.cpu(), want.exp_avg_sq[k].cpu()))
    return (live.count == want.count and set(want.exp_avg) <= set(
        live.exp_avg) and all(same(k, m, live.exp_avg_sq[k])
                              for k, m in live.exp_avg.items()))


def restored_state_check(engine, last_dir, expect=None):
    """The engine's step counter, Adam state and parameters right after a
    resume, against ``last_dir``'s files (the JAX package's
    ``params.msgpack`` / ``opt_state.msgpack`` through this package's
    reader) and, where given, against ``expect``: the preempted run's own
    state (:func:`host_state`). ``(meta step, step equal, Adam state equal
    bit for bit, parameters equal bit for bit)``."""
    meta = json.loads((last_dir / "train_meta.json").read_text())
    live = host_state(engine)
    saved = jax_adam_state(load_flax_params(last_dir / "opt_state.msgpack"),
                           load_flax_params(last_dir / "params.msgpack"))
    wants = [(saved, read_params(last_dir))]
    if expect is not None:
        wants.append((expect["adam"], expect["params"]))
    params = live["params"]
    return {"meta_step": meta["step"],
            "step_same": engine.step_count == meta["step"] == (
                expect or meta)["step"],
            "adam_same": all(same_adam(live["adam"], a) for a, _ in wants),
            "params_same": all(
                params.keys() == p.keys() and all(
                    torch.equal(v, p[k]) for k, v in params.items())
                for _, p in wants)}


def dir_gb(path) -> float:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file()) / 1e9


def ckpt_seconds(recs) -> float:
    return sum(e["ckpt_seconds"] for r in recs for e in r.get("history", []))


def per_step(counts, steps):
    return {k: v / max(steps, 1) for k, v in counts.items()}


def phase_pr_trainer(root, cp_csv, hprc_csv, card):
    """8a: ``train_pr.main`` through its argv (full width, bf16, the FE
    trainable, laptop, ``beam_device`` validation): its artifacts, the
    step's launches, and ``load_predictor(best)`` against the model in
    memory, bit for bit."""
    exp = Path(root) / "pr"
    argv = ["--exp_dir", str(exp), "--cp_csv_path", str(cp_csv),
            "--hprc_csv_path", str(hprc_csv), "--laptop", "--batch_size",
            "4", "--samples_per_epoch", "8", "--val_decode", "beam_device",
            "--platform", PLATFORM]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FitProbe(train_pr) as probe:
        history, results = train_pr.main(argv)
    run_s = time.perf_counter() - t0
    rec = probe.calls[0]
    steps = history[0]["train_steps"]
    counts = rec["epochs"][0]
    want = ["vocab.json", "train.csv", "valid.csv", "test.csv",
            "test_results.json", "metrics.jsonl", "experiment_args.json",
            "best-model-ckpt/params.msgpack",
            "best-model-ckpt/model_cfg.json",
            "last-model-ckpt/params.msgpack",
            "last-model-ckpt/opt_state.msgpack",
            "last-model-ckpt/train_meta.json"]
    missing = [f for f in want if not (exp / f).exists()]
    layers = rec["model"].cfg.num_hidden_layers
    log(f"  8a train_pr.main {' '.join(argv[6:])}: {run_s:.1f} s, "
        f"{steps} step(s), launches a step {per_step(counts, steps)}, "
        f"history {history}, test {results}; checkpoints "
        f"{ckpt_seconds([rec]):.2f} s, run directory {dir_gb(exp):.2f} GB; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    if missing or steps != 1 or not (
            all(counts[k] == layers for k in FLASH)
            and counts["fused_conv_ln_gelu"] == 0):
        raise AssertionError(f"8a: missing {missing} or launches {counts}")
    if not (np.isfinite(history[0]["mean_train_loss"])
            and all(np.isfinite(v) for v in results.values())
            and set(results) == {"mean_cp_test_per", "mean_hprcN_per",
                                 "mean_hprcF_per"}):
        raise AssertionError("8a: a non-finite loss or a missing result")

    rng = np.random.default_rng(8)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 40_000, 23_456)]
    live = W2V2PRPredictor(rec["model"]).encode_batch(wavs)
    loaded = load_predictor(exp).encode_batch(wavs)
    same = torch.equal(live["phoneme_logits"], loaded["phoneme_logits"])
    log(f"  8a load_predictor(best).encode_batch vs the model in memory: "
        f"logits {tuple(live['phoneme_logits'].shape)} bit-identical {same}")
    if not same:
        raise AssertionError("8a: the loaded checkpoint serves other logits")
    del live, loaded, rec, probe
    torch.cuda.empty_cache()
    shutil.rmtree(exp / "last-model-ckpt")  # 8b reads the best only
    return exp


class _CountedCorpus(FrozenEncodedCorpus):
    built = 0

    def __init__(self, *args, **kwargs):
        _CountedCorpus.built += 1
        super().__init__(*args, **kwargs)


class _CountedFoldCache(FrozenEncodedLoader):
    built = 0

    def __init__(self, *args, **kwargs):
        _CountedFoldCache.built += 1
        super().__init__(*args, **kwargs)


def phase_force_trainer(root, hprc_csv, pr_exp, speakers, card):
    """8b: ``train_force_aptai.run`` over 8a's run (2 folds, the corpus
    cache): ``pr_spliced``, one corpus pass, head-only saves beside one
    ``frozen_tower.msgpack``, whole-model best and last after the fold,
    ``load_predictor(best)`` serving with 8a's tower bit for bit; then one
    fold whose collapse guard falls back to ``beam_host``. Returns the
    first fold's best checkpoint, moved to ``root/force_best``."""
    def config(name, **kw):
        return ForceAPTAIConfig(
            exp_dir=str(Path(root) / name), hprc_csv_path=str(hprc_csv),
            pr_model_path=str(pr_exp), vocab_path=str(pr_exp / "vocab.json"),
            laptop=True, batch_size=4, platform=PLATFORM,
            **kw).finalize("FORCE_APTAI")

    cfg = config("force")
    real = (train_force_aptai.FrozenEncodedCorpus,
            train_force_aptai.FrozenEncodedLoader)
    train_force_aptai.FrozenEncodedCorpus = _CountedCorpus
    train_force_aptai.FrozenEncodedLoader = _CountedFoldCache
    _CountedCorpus.built = _CountedFoldCache.built = 0
    try:
        t0 = time.perf_counter()
        with FitProbe(train_force_aptai) as probe:
            mean, _, per = train_force_aptai.run(cfg, speakers=speakers)
        run_s = time.perf_counter() - t0
        corpus_passes, fold_passes = (_CountedCorpus.built,
                                      _CountedFoldCache.built)

        fold_dirs = [Path(cfg.exp_dir) / f"best-model-ckpt-{s}"
                     for s in speakers]
        model_cfg = json.loads((fold_dirs[0] / "best-model-ckpt"
                                / "model_cfg.json").read_text())
        whole = ["w2v2_pr" in flax_keys(d / sub / "params.msgpack")
                 for d in fold_dirs for sub in ("best-model-ckpt",
                                                "last-model-ckpt")]
        towers = [(d / "frozen_tower.msgpack").exists() for d in fold_dirs]
        stale = [str(p) for d in fold_dirs for p in d.rglob("*.pt")]
        head_only = [not r["best_has_tower"] for r in probe.calls]
        counts = [per_step(r["epochs"][0], r["history"][0]["train_steps"])
                  for r in probe.calls]
        log(f"  8b train_force_aptai.run, folds {speakers}: {run_s:.1f} s; "
            f"pr_spliced {model_cfg['pr_spliced']}; corpus cache built "
            f"{corpus_passes} time(s), fold caches {fold_passes}; saves "
            f"head-only during fit {head_only}, frozen_tower.msgpack "
            f"{towers}, no .pt file {not stale}, "
            f"best/last whole after the fold {whole}; head-step launches "
            f"{counts}; checkpoints {ckpt_seconds(probe.calls):.2f} s, run "
            f"directory {dir_gb(cfg.exp_dir):.2f} GB; LOSO mean "
            f"test_N_mean_rmse {mean['test_N_mean_rmse']:.4f}")
        if not (model_cfg["pr_spliced"] and corpus_passes == 1
                and fold_passes == 0 and all(head_only) and all(towers)
                and all(whole) and not stale and len(per) == len(speakers)
                and all(np.isfinite(v) for r in per for v in r.values())
                and not any(any(c.values()) for c in counts)):
            raise AssertionError("8b: the FORCE trainer's run is wrong")

        pred = load_predictor(fold_dirs[0])
        tower_8a = read_params(pr_exp / "best-model-ckpt")
        served = pred.model.w2v2_pr.state_dict()
        rng = np.random.default_rng(9)
        out = fetch_outputs(pred.predict_batch(
            [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for n in (16_000, 30_000)]))
        # the served copy casts the encoder's matmul weights to bf16: hold
        # the loaded model's tower, before that cast, to 8a's
        _, loaded, _ = load_model(fold_dirs[0])
        tower_same = all(torch.equal(v, tower_8a[k]) for k, v in
                         loaded.w2v2_pr.state_dict().items())
        log(f"  8b load_predictor(best) serves: tvs_pred "
            f"{out['tvs_pred'].shape} finite "
            f"{bool(np.isfinite(out['tvs_pred']).all())}; tower bit-identical "
            f"to 8a's best {tower_same} ({len(served)} tensors)")
        if not (tower_same and np.isfinite(out["tvs_pred"]).all()):
            raise AssertionError("8b: the FORCE checkpoint does not serve "
                                 "8a's tower")
        del pred, loaded, tower_8a, served, probe
        force_best = Path(root) / "force_best"  # phase 9's FORCE checkpoint
        shutil.move(fold_dirs[0] / "best-model-ckpt", force_best)
        shutil.rmtree(cfg.exp_dir)

        cfg = config("force_fallback", collapse_per_threshold=0.0,
                     collapse_patience=1, collapse_fallback=True)
        t0 = time.perf_counter()
        with FitProbe(train_force_aptai) as probe:
            _, _, per = train_force_aptai.run(cfg, speakers=speakers[:1])
        methods = [r["decode_method"] for r in probe.calls]
        log(f"  8b collapse fallback, fold {speakers[0]}: "
            f"{time.perf_counter() - t0:.1f} s, decode_fallback "
            f"{per[0]['decode_fallback']}, fits under {methods}, "
            f"test_N_ctc_seq_per {per[0]['test_N_ctc_seq_per']:.4f}")
        if not (per[0]["decode_fallback"] == 1
                and methods == ["greedy", "beam_host"]
                and all(np.isfinite(v) for v in per[0].values())):
            raise AssertionError("8b: the collapse fallback did not run")
        shutil.rmtree(cfg.exp_dir)
    finally:
        (train_force_aptai.FrozenEncodedCorpus,
         train_force_aptai.FrozenEncodedLoader) = real
    torch.cuda.empty_cache()
    return force_best


def phase_aptai_trainer(root, hprc_csv, spk, card):
    """8c: ``train_aptai.run`` on one fold over 2 epochs from the FE cache,
    preempted by SIGTERM during epoch 2, then resumed; the epoch's launches
    and step ms beside ``TrainStep`` alone on the same batches. Returns
    the run's directory, the fold's test dict and the epoch's launches."""
    def config():
        return APTAIConfig(exp_dir=str(Path(root) / "aptai"),
                           hprc_csv_path=str(hprc_csv), batch_size=4,
                           num_epochs=2, platform=PLATFORM,
                           ).finalize("APTAI")

    cfg = config()
    t0 = time.perf_counter()
    preempted = False
    with FitProbe(train_aptai, sigterm_at=(1, 1)) as probe:
        try:
            train_aptai.run(cfg, speakers=[spk])
        except Preempted:
            preempted = True
    first_s = time.perf_counter() - t0
    rec = probe.calls[0]
    last = Path(cfg.exp_dir) / f"best-model-ckpt-{spk}" / "last-model-ckpt"
    meta = json.loads((last / "train_meta.json").read_text())
    epoch1 = rec["epochs"][0]
    steps1 = len(rec["batches"])
    layers = rec["model"].cfg.num_hidden_layers
    log(f"  8c train_aptai.run, fold {spk}, 2 epochs from the FE cache: "
        f"SIGTERM during epoch 2 -> Preempted {preempted} after "
        f"{first_s:.1f} s; resume checkpoint {meta}; epoch 1: {steps1} "
        f"steps, launches {epoch1} ({per_step(epoch1, steps1)} a step)")
    if not (preempted and meta.get("preempted") and meta["epoch"] == 0
            and meta["step"] == rec["engine"].step_count > steps1):
        raise AssertionError("8c: the preemption did not write the resume "
                             "checkpoint")
    if not (epoch1["fused_conv_ln_gelu"] == 0
            and all(epoch1[k] == layers * steps1 for k in FLASH)):
        raise AssertionError(f"8c: launches of the epoch {epoch1}")
    batches, at_exit = rec["batches"], rec["at_exit"]
    del rec, probe
    torch.cuda.empty_cache()

    cfg = config()
    t0 = time.perf_counter()
    with FitProbe(train_aptai, expect=at_exit) as probe:
        _, _, per = train_aptai.run(cfg, speakers=[spk])
    rec = probe.calls[0]
    hist = rec["history"]
    log(f"  8c resumed run: {time.perf_counter() - t0:.1f} s; restored "
        f"{rec.get('resume')}; epochs run {[e['epoch'] for e in hist]}; "
        f"checkpoints {ckpt_seconds([rec]):.2f} s, run directory "
        f"{dir_gb(cfg.exp_dir):.2f} GB")
    resume = rec.get("resume", {})
    if not ([e["epoch"] for e in hist] == [1] and resume.get("step_same")
            and resume.get("adam_same") and resume.get("params_same")):
        raise AssertionError("8c: the resumed run did not restore the step, "
                             "Adam state and parameters bit for bit")
    fit_ms = hist[0]["train_seconds"] / hist[0]["train_steps"] * 1e3
    epoch2 = rec["epochs"][0]

    # TrainStep alone on the same batches, from a fresh model, built as fit
    # builds it
    del rec, probe
    torch.cuda.empty_cache()
    model, _ = build_aptai_model(cfg, train_aptai.read_hprc(cfg)[1])
    step = make_engine(cfg, aptai_loss_fn(from_features=True), model)

    def pass_ms():
        t0 = time.perf_counter()
        for b in batches:
            step(b, 1e-5)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(batches) * 1e3

    # the first pass is cold, as the resumed run's epoch is (fresh model,
    # its activations allocated anew); the second is warm
    cold_ms, warm_ms = pass_ms(), pass_ms()
    log(f"  8c step ms: fit's epoch 2 {fit_ms:.2f} (train_seconds / "
        f"train_steps over {hist[0]['train_steps']} steps) vs TrainStep "
        f"alone on epoch 1's {len(batches)} batches {cold_ms:.2f} cold, "
        f"{warm_ms:.2f} warm on {card}; epoch 2 launches {epoch2}")
    del step, model
    torch.cuda.empty_cache()
    return Path(cfg.exp_dir), per[0], (epoch2, hist[0]["train_steps"])


def phase_eval_cli(aptai_exp, spk, fold_results, hprc_csv, card):
    """8d: ``eval_cli.main`` on 8c's best checkpoint, the held-out speaker,
    both rates, at the trainer's batch size: its JSON against the fold's
    test dict within 1e-4 relative."""
    ckpt = aptai_exp / f"best-model-ckpt-{spk}"
    argv = [str(ckpt), str(hprc_csv), "--speaker", spk, "--rate", "N,F",
            "--batch_size", "4"] + (["--cpu"] if PLATFORM == "cpu" else [])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = eval_cli.main(argv)
    got = json.loads(out.getvalue()) if rc == 0 else {}
    worst = max((abs(got[k] - v) / max(abs(v), 1e-12)
                 for k, v in fold_results.items() if k in got),
                default=float("inf"))
    missing = sorted(set(fold_results) - set(got))
    log(f"  8d eval_cli {' '.join(argv[2:])}: rc {rc} in "
        f"{time.perf_counter() - t0:.1f} s, {len(got)} keys, largest "
        f"relative difference to the fold's test dict {worst:.2e}, missing "
        f"{missing} on {card}")
    if rc != 0 or missing or not worst <= 1e-4:
        raise AssertionError("8d: eval_cli disagrees with the trainer's test")


def phase_trainers(card, root):
    """Phase 8 in the directory ``root``: returns the APTAI trainer's epoch
    launches and steps, and the APTAI and FORCE checkpoints it leaves
    there for phase 9."""
    log("== phase 8: the trainers at full width")
    t_phase = time.perf_counter()
    cp_csv = make_synthetic_commonphone(root / "cp", 8, 2, 2)
    hprc_csv = make_synthetic_hprc(root / "hprc", 3, HPRC_SPEAKERS[:4])
    speakers = [r["speaker"] for r in read_rows(hprc_csv)]
    speakers = list(dict.fromkeys(speakers))
    pr_exp = phase_pr_trainer(root, cp_csv, hprc_csv, card)
    force_best = phase_force_trainer(root, hprc_csv, pr_exp, speakers[:2],
                                     card)
    shutil.rmtree(pr_exp)
    aptai_exp, fold_results, epoch = phase_aptai_trainer(
        root, hprc_csv, speakers[-1], card)
    phase_eval_cli(aptai_exp, speakers[-1], fold_results, hprc_csv, card)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return epoch, aptai_exp / f"best-model-ckpt-{speakers[-1]}", force_best


# -- phase 9 ------------------------------------------------------------------

STREAM_KW = dict(chunk_seconds=20.0, overlap_seconds=2.0, chunk_batch=4)
STREAM_SECONDS = 600.0
STREAM_CLASSES = {"aptai": StreamingAPTAI, "w2v2_pr": StreamingW2V2PR,
                  "force_aptai": StreamingForceAPTAI}
FRAME_KEYS = {"aptai": "phn_fc_pred", "force_aptai": "pred_frame_phns"}


def synthetic_recording(seconds: float, seed: int = 0) -> np.ndarray:
    """``seconds`` of the synthetic corpora's phone-driven audio
    (``data/synthetic.py``), utterance after utterance, quantized to 16-bit
    PCM (so the int16 transfer of it is lossless)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    parts, total = [], 0
    while total < n:
        parts.append(_random_utterance(rng)[2])
        total += len(parts[-1])
    return (quantize_i16(np.concatenate(parts)[:n]).astype(np.float32)
            / np.float32(32768.0))


def stream_groups(streamer, n: int):
    """The chunk groups a streamer runs for ``n`` samples, and the frame
    lengths of the last group's slots (a partial group's empty slots run
    at the chunk's length)."""
    s = streamer
    starts = [0] if n <= s.chunk else list(range(0, n - s.overlap, s.hop))
    lens = [min(s.chunk, n - st) for st in starts]
    g = s.chunk_batch
    last = lens[(len(lens) - 1) // g * g:]
    last += [s.chunk] * (g - len(last))
    frames = [int(s.model.cfg.feat_extract_output_lengths(x)) for x in last]
    return -(-len(starts) // g), frames


def flat_stream(out):
    """A streamer's output as arrays by key, the per-TV dict stacked."""
    flat = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    if "tvs_pred" in out:
        flat["tvs_pred"] = np.stack([out["tvs_pred"][k] for k in TV_ORDER],
                                    1)
    return flat


def same_stream(a, b) -> bool:
    fa, fb = flat_stream(a), flat_stream(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k])
                                          for k in fa)


def served_agreement(got, want):
    """The served-model gates of two outputs of one recording (dicts of
    (T, ...) arrays, the TVs stacked): the least Pearson (per TV; the
    logits flattened) and the least frame agreement (the frame phonemes;
    the logits' argmax)."""
    rs, agree = [], []
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            return -1.0, 0.0
        if k == "phoneme_logits":
            rs.append(pearson(g.ravel(), w.ravel()))
            agree.append(float(np.mean(g.argmax(-1) == w.argmax(-1))))
        elif w.dtype.kind == "f" and w.ndim == 2 and k == "tvs_pred":
            rs += [pearson(g[:, i], w[:, i]) for i in range(w.shape[1])]
        elif w.dtype.kind in "iu":
            agree.append(float(np.mean(g == w)))
    return min(rs, default=1.0), min(agree, default=1.0)


def timed_stream(streamer, wav):
    """One stream of ``wav`` with the launch counts set to 0 just before:
    (output, wall s, counts, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = streamer.predict(wav)  # waits for its last copy to the host
    wall = time.perf_counter() - t0
    counts = read_counts()
    return out, wall, counts, torch.cuda.max_memory_allocated() / 2 ** 30


def stream_family(kind, model, pred, wav, card):
    """9a for one family: the long recording streamed (launches a group,
    the stitched length, audio-s/s, peak memory), then per_file,
    upload_ahead and the int16 transfer bit for bit against it, and a
    recording shorter than a chunk against ``pred.predict_batch``."""
    cfg = model.cfg
    fused = bool(cfg.fused_feature_extractor)
    streamer = STREAM_CLASSES[kind](pred.model, **STREAM_KW)
    streamer.predict(wav[:SAMPLE_RATE])  # warm: cuDNN plans, pinned pool
    out, wall, counts, peak = timed_stream(streamer, wav)
    groups, last_frames = stream_groups(streamer, len(wav))
    n_frames = int(cfg.feat_extract_output_lengths(len(wav)))
    lengths = {k: len(v) for k, v in flat_stream(out).items()}
    variants = {}
    for name, kw in (("per_file", dict(fetch_mode="per_file")),
                     ("upload_ahead", dict(upload_ahead=True)),
                     ("int16", dict(transfer_dtype="int16"))):
        other = STREAM_CLASSES[kind](pred.model, **STREAM_KW, **kw)
        variants[name] = same_stream(other.predict(wav), out)
    short = wav[:int(7.3 * SAMPLE_RATE)]
    batch = fetch_outputs(pred.predict_batch([short]) if kind != "w2v2_pr"
                          else pred.encode_batch([short]))
    n_short = int(batch["frame_lengths"][0])
    keys = tuple(flat_stream(out))
    r, agree = served_agreement(
        flat_stream(streamer.predict(short)),
        {k: batch[k][0, :n_short] for k in keys})
    want = {"flash_attn_fwd": cfg.num_hidden_layers * groups,
            "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
            "fused_conv_ln_gelu": 6 * groups if fused else 0}
    log(f"  9a {kind}{' (fused FE)' if fused else ''}: {STREAM_SECONDS:.0f} s "
        f"streamed in {groups} groups of {STREAM_KW['chunk_batch']} x "
        f"{STREAM_KW['chunk_seconds']:.0f} s chunks: {wall:.3f} s wall, "
        f"{STREAM_SECONDS / wall:.1f} audio-s/s, peak {peak:.2f} GiB on "
        f"{card}; launches {counts} ({per_step(counts, groups)} a group); "
        f"stitched lengths {lengths} (want {n_frames}); bit-identical "
        f"{variants}; 7.3 s streamed vs predict_batch: Pearson min "
        f"{r:.6f}, frame agreement {agree:.4%}")
    if not (counts == want and set(lengths.values()) == {n_frames}
            and all(variants.values()) and r >= 0.999 and agree >= 0.99
            and all(np.isfinite(v).all() for v in flat_stream(out).values()
                    if v.dtype.kind == "f")):
        raise AssertionError(f"9a: the {kind} stream is wrong (launches "
                             f"want {want})")
    return counts, groups, last_frames


def check_streamed_kernel_shapes(streamer_frames):
    """Kernels 1 and 4 against their plain versions at the streamed shape
    (4 chunks of 20 s: T = 999; the last group's frame lengths), under
    phase 2's tolerances."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    t = max(streamer_frames)
    q, k, v = _qkv(gen, len(streamer_frames), 16, t, torch.bfloat16, True)
    check_kernel_case(f"flash forward at the streamed shape "
                      f"{len(streamer_frames)} x {t}", q, k, v, None,
                      streamer_frames, backward=False)
    length = (int(STREAM_KW["chunk_seconds"] * SAMPLE_RATE) - 10) // 5 + 1
    lengths = [length]
    for kk in FE_KERNELS[:-1]:
        lengths.append((lengths[-1] - kk) // 2 + 1)
    for i in (0, 5):
        x, w, bb, ln_w, ln_b = fused_operands(
            gen, len(streamer_frames), lengths[i], 512, 512, FE_KERNELS[i],
            torch.bfloat16, bias=i == 0)
        got = fused_conv.fused_conv_ln_gelu_cuda(x, w, bb, ln_w, ln_b, 2)
        torch.cuda.synchronize()
        want = fused_conv.fused_conv_ln_gelu_plain(x, w, bb, ln_w, ln_b, 2)
        err = _check_fused(f"layer {i + 1} at the streamed shape", got, want,
                           torch.bfloat16)
        log(f"  fused_conv_ln_gelu layer {i + 1} at the streamed shape: x "
            f"{tuple(x.shape)} -> T_out {got.shape[1]}, max_abs_err "
            f"{err:.3e}")


def check_small_stream_reference():
    """A small float32 APTAI streamed on the card against the same stream
    on the CPU (which runs the plain attention): TVs and probabilities
    within 1e-4 of their largest magnitude, frame phonemes ≥ 99 %."""
    model = random_aptai(small_force_config(), seed=1, num_phonemes=46)
    wav = synthetic_recording(50.0, seed=3)
    kw = dict(chunk_seconds=8.0, overlap_seconds=1.0, chunk_batch=2,
              frame_keys=("tvs_pred", "phn_fc_pred", "phn_fc_probs"))
    runs = [flat_stream(StreamingAPTAI(model, device=dev, **kw).predict(wav))
            for dev in ("cpu", "cuda")]
    errs = {k: float(np.abs(runs[1][k] - runs[0][k]).max()
                     / max(np.abs(runs[0][k]).max(), 1e-30))
            for k in ("tvs_pred", "phn_fc_probs")}
    agree = float(np.mean(runs[1]["phn_fc_pred"] == runs[0]["phn_fc_pred"]))
    log(f"  small f32 APTAI streamed, card vs CPU: relative errors "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }, frame phonemes "
        f"agree {agree:.4%} over {len(runs[0]['phn_fc_pred'])} frames")
    if not (all(v <= 1e-4 for v in errs.values()) and agree >= 0.99):
        raise AssertionError("9a: the card's stream disagrees with the CPU's")


def phase_streaming(card):
    """9a: the three families' streamers at full width (random weights,
    seed 0) over 10 minutes of synthetic audio."""
    wav = synthetic_recording(STREAM_SECONDS)
    cfg = Wav2Vec2Config(dtype="bfloat16")
    check_small_stream_reference()
    out = {}
    for kind, build in (
            ("aptai", lambda: (random_aptai(cfg, seed=0), APTAIPredictor)),
            ("w2v2_pr", lambda: (random_w2v2_pr(dataclasses.replace(
                cfg, fused_feature_extractor=True), seed=0),
                W2V2PRPredictor)),
            ("force_aptai", lambda: (random_force_aptai(cfg, seed=0),
                                     ForceAPTAIPredictor))):
        t0 = time.perf_counter()
        model, cls = build()
        pred = cls(model)
        log(f"  full-width {kind} (bf16, seed 0) on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        out[kind] = stream_family(kind, model, pred, wav, card)
        del model, pred
        torch.cuda.empty_cache()
    check_streamed_kernel_shapes(out["aptai"][2])
    return out


def http_load(port, reqs, threads=16):
    """``reqs`` ((body, headers) each) POSTed to ``/v1/predict`` by
    ``threads`` clients, each on its own kept-alive connection: (status
    and body of each, client latency s of each, wall s)."""
    results = [None] * len(reqs)
    lat = [float("nan")] * len(reqs)

    def client(indices):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in indices:
                body, hdr = reqs[i]
                t0 = time.perf_counter()
                conn.request("POST", "/v1/predict", body=body, headers=hdr)
                r = conn.getresponse()
                results[i] = (r.status, r.read())
                lat[i] = time.perf_counter() - t0
        finally:
            conn.close()

    workers = [threading.Thread(target=client, args=(
        list(range(k, len(reqs), threads)),)) for k in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    return results, np.asarray(lat), time.perf_counter() - t0


def check_http_answers(results, direct, what):
    """Every response 200 with ``ServingApp.handle``'s frame count for the
    same audio, and over all of them phase 3's served-model gates against
    it (per-TV Pearson ≥ 0.999 and frame-phoneme agreement ≥ 99 % over
    the frames of every response together). Returns (least per-TV
    Pearson, agreement, least Pearson of one response)."""
    got_tv, want_tv, got_ph, want_ph, single = [], [], [], [], 1.0
    for res, (status, data, _) in zip(results, direct):
        if res is None or res[0] != 200 or status != 200:
            raise AssertionError(f"9b: a {what} request failed: "
                                 f"{None if res is None else res[0]}")
        got, want = json.loads(res[1]), json.loads(data)
        if got["frames"] != want["frames"]:
            raise AssertionError(f"9b: {what} frame counts differ")
        got_tv.append(np.stack([got["tvs_pred"][k] for k in TV_ORDER], 1))
        want_tv.append(np.stack([want["tvs_pred"][k] for k in TV_ORDER], 1))
        got_ph.append(np.asarray(got["phn_fc_pred"]))
        want_ph.append(np.asarray(want["phn_fc_pred"]))
        single = min(single, served_agreement(
            {"tvs_pred": got_tv[-1]}, {"tvs_pred": want_tv[-1]})[0])
    r, a = served_agreement(
        {"tvs_pred": np.concatenate(got_tv),
         "phn_fc_pred": np.concatenate(got_ph)},
        {"tvs_pred": np.concatenate(want_tv),
         "phn_fc_pred": np.concatenate(want_ph)})
    if r < 0.999 or a < 0.99:
        raise AssertionError(f"9b: {what} disagrees with ServingApp: "
                             f"Pearson {r:.6f}, agreement {a:.4%}")
    return r, a, single


def replayed_identical(app, batches, reqs, results):
    """Each batch the batcher formed, run again as it was formed and
    formatted as the transports format a response: how many responses
    are byte for byte what the transport sent."""
    index = {decode_wire_audio(body, hdr.get("Content-Type", ""),
                               hdr.get("X-Audio-Encoding"), None,
                               app.max_seconds).tobytes(): i
             for i, (body, hdr) in enumerate(reqs)}
    same = 0
    for wavs in batches:
        for wav, item in zip(wavs, app.batcher.run_batch(wavs)):
            status, payload = app._filter_fields(
                app._format(item, len(wav)), {})
            data = app._encode(status, payload, "json")[1]
            i = index.get(wav.tobytes())
            same += i is not None and results[i][1] == data
    return same


def latency_text(lat):
    p50, p95, p99 = (np.percentile(lat, q) * 1e3 for q in (50, 95, 99))
    return f"latency p50 {p50:.1f} / p95 {p95:.1f} / p99 {p99:.1f} ms"


def phase_http(aptai_ckpt, card):
    """9b: ``build_app`` over phase 8's APTAI run behind the native
    transport: 256 requests of 1-10 s from 16 clients, float32 and int16;
    64 of them through the Python transport; a 2-minute ``/v1/stream`` in
    the binary format; ``/healthz`` and ``/metrics``. Returns the flash
    launches of one batch served with no other traffic."""
    t0 = time.perf_counter()
    app = build_app(str(aptai_ckpt), max_batch_size=16, max_wait_ms=10.0,
                    **STREAM_KW)
    log(f"  build_app over phase 8's APTAI run (warm-up included) in "
        f"{time.perf_counter() - t0:.1f} s")
    inner, batches = app.batcher.predict_batch, []

    def counted(wavs, fields=None, real_rows=None):
        batches.append(list(wavs[:real_rows]))  # the requests' own audio
        return inner(wavs, fields=fields, real_rows=real_rows)

    app.batcher.predict_batch = counted
    native_srv = make_native_server(app, "127.0.0.1", 0)
    py_srv = None
    try:
        port = native_srv.port
        recording = synthetic_recording(STREAM_SECONDS, seed=1)
        rng = np.random.default_rng(0)
        secs = rng.uniform(1.0, 10.0, 256)
        starts = rng.integers(0, len(recording) - 10 * SAMPLE_RATE, 256)
        reqs = []
        for i, (s, st) in enumerate(zip(secs, starts)):
            wav = recording[st:st + int(s * SAMPLE_RATE)]
            reqs.append((quantize_i16(wav).tobytes(),
                         {"X-Audio-Encoding": "int16"}) if i % 2 else
                        (wav.tobytes(), {"Content-Type":
                                         "application/octet-stream"}))
        audio_s = float(sum(int(s * SAMPLE_RATE) for s in secs)) / SAMPLE_RATE

        reset_counts()
        batches.clear()
        status, _, _ = request_once(port, "POST", "/v1/predict", *reqs[0])
        one = read_counts()
        layers = app.streamer.model.cfg.num_hidden_layers
        if not (status == 200 and len(batches) == 1
                and one["flash_attn_fwd"] == layers
                and sum(one.values()) == layers):
            raise AssertionError(f"9b: one request made {len(batches)} "
                                 f"batch(es) with launches {one}")

        served = {}
        for what, port_, sub in (("native", port, reqs),
                                 ("python", None, reqs[:64])):
            if port_ is None:
                py_srv = make_server(app, "127.0.0.1", 0)
                threading.Thread(target=py_srv.serve_forever,
                                 daemon=True).start()
                port_ = py_srv.server_address[1]
            batches.clear()
            results, lat, wall = http_load(port_, sub)
            served[what] = (results, lat, wall, list(batches))
        app.batcher.predict_batch = inner
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            direct = list(pool.map(lambda r: app.handle(
                "POST", "/v1/predict", r[1], r[0]), reqs))
        for what, (results, lat, wall, formed) in served.items():
            n = len(results)
            sub_s = float(sum(int(x * SAMPLE_RATE) for x in secs[:n])
                          ) / SAMPLE_RATE
            r, a, single = check_http_answers(results, direct[:n], what)
            same = replayed_identical(app, formed, reqs[:n], results)
            log(f"  9b {what} transport: {n} requests ({sub_s:.1f} "
                f"audio-s, float32 and int16) from 16 clients in "
                f"{wall:.3f} s: {n / wall:.1f} requests/s, "
                f"{sub_s / wall:.1f} audio-s/s, {latency_text(lat)} on "
                f"{card}; {len(formed)} batches of mean "
                f"{np.mean([len(b) for b in formed]):.2f} requests (max "
                f"16); responses byte for byte a replay of their batch "
                f"{same}/{n}; against ServingApp.handle: per-TV Pearson "
                f"min {r:.6f} (one response's min {single:.6f}), frame "
                f"agreement {a:.4%}")
            if same != n:
                raise AssertionError(f"9b: {what} responses differ from "
                                     "their batches' replay")
        log(f"  9b one batch alone launched {one}")

        wav = recording[:120 * SAMPLE_RATE]
        t0 = time.perf_counter()
        status, ctype, data = request_once(port, "POST",
                                           "/v1/stream?format=binary",
                                           wav.tobytes(), {})
        stream_s = time.perf_counter() - t0
        got = decode_binary(data) if status == 200 else {}
        want = app.streamer.predict(wav)
        n_frames = int(app.streamer.model.cfg.feat_extract_output_lengths(
            len(wav)))
        same = status == 200 and same_stream(got, want)
        r, a = served_agreement(flat_stream(got), flat_stream(want)) if (
            status == 200) else (-1.0, 0.0)
        health = request_once(port, "GET", "/healthz", None, {})
        metrics = request_once(port, "GET", "/metrics", None, {})
        m = json.loads(metrics[2]) if metrics[0] == 200 else {}
        log(f"  9b /v1/stream, 120 s, binary: {status} {ctype} in "
            f"{stream_s:.3f} s, {got.get('frames')} frames (want "
            f"{n_frames}), against the streamer called directly: "
            f"bit-identical {same}, Pearson min {r:.6f}, agreement {a:.4%}; "
            f"/healthz {health[0]}; /metrics {metrics[0]}: requests "
            f"{m.get('requests_total')}, errors {m.get('errors_total')}, "
            f"server-side p50 {m.get('latency_p50_ms')} / p95 "
            f"{m.get('latency_p95_ms')} ms, stream_rtf {m.get('stream_rtf')}")
        if not (status == 200 and got["frames"] == n_frames and r >= 0.999
                and a >= 0.99 and health[0] == 200 and metrics[0] == 200
                and m.get("errors_total") == 0):
            raise AssertionError("9b: /v1/stream, /healthz or /metrics")
        return one
    finally:
        native_srv.shutdown()
        if py_srv is not None:
            py_srv.shutdown()
            py_srv.server_close()
        app.batcher.stop()


def request_once(port, method, path, body, headers):
    """(status, content type, body) of one request on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def phase_cli(root, aptai_ckpt, force_ckpt, card):
    """9c: ``python -m aptai_tpu_torch.infer`` in subprocesses on the card,
    both started together: 8 wavs over phase 8's APTAI run (its JSON lines
    against ``predict_batch`` in the same batches of 4), and ``--task
    alignment`` over its FORCE run (against ``get_alignment``: the same
    shape, per-frame argmax over the phonemes ≥ 99 %; a run whose greedy
    decode is empty aligns no phoneme, in both)."""
    rng = np.random.default_rng(2)
    recording = synthetic_recording(90.0, seed=2)
    wavs, paths = [], []
    (root / "wavs").mkdir()
    for i, s in enumerate(rng.uniform(1.0, 10.0, 8)):
        st = int(rng.integers(0, len(recording) - 10 * SAMPLE_RATE))
        wavs.append(recording[st:st + int(s * SAMPLE_RATE)])
        paths.append(str(root / "wavs" / f"utt{i}.wav"))
        save_wav(paths[-1], wavs[-1], SAMPLE_RATE)
    here = Path(__file__).resolve().parent
    env = _package_env()
    extra = ["--cpu"] if PLATFORM == "cpu" else []
    argvs = {"aptai": [str(aptai_ckpt), *paths, "--batch_size", "4"],
             "alignment": [str(force_ckpt), *paths[:3], "--task",
                           "alignment"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "aptai_tpu_torch.infer", *argv, *extra],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k, argv in argvs.items()}
    try:
        pred = load_predictor(aptai_ckpt)
        want = [fetch_outputs(pred.predict_batch(
            wavs[i:i + 4], fields=("tvs_pred", "phn_fc_pred")))
            for i in range(0, 8, 4)]
        del pred
        fpred = load_predictor(force_ckpt)
        want_al = [fpred.get_alignment(w)["alignment"] for w in wavs[:3]]
        del fpred
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    rcs = {k: p.returncode for k, p in procs.items()}
    if any(rcs.values()):
        raise AssertionError(f"9c: the CLI failed: {rcs}: "
                             + " | ".join(e[-2000:] for _, e in outs.values()))
    lines = [json.loads(x) for x in outs["aptai"][0].splitlines()]
    worst_r, worst_a, worst_err = 1.0, 1.0, 0.0
    for i, line in enumerate(lines):
        w = want[i // 4]
        n = int(w["frame_lengths"][i % 4])
        tv_w = w["tvs_pred"][i % 4, :n]
        tv_g = np.stack([line["tvs_pred"][k] for k in line["tvs_pred"]], 1)
        r, a = served_agreement(
            {"tvs_pred": tv_g, "phn_fc_pred": np.asarray(
                line["pred_frame_phns"])},
            {"tvs_pred": tv_w, "phn_fc_pred": w["phn_fc_pred"][i % 4, :n]})
        worst_r, worst_a = min(worst_r, r), min(worst_a, a)
        if tv_g.shape == tv_w.shape:
            worst_err = max(worst_err, float(np.abs(tv_g - tv_w).max()))
    aligns = [np.asarray(json.loads(x)["alignment"], np.float32)
              for x in outs["alignment"][0].splitlines()]
    cfg = Wav2Vec2Config()
    al_agree, al_err = 1.0, 0.0
    for got, want, w in zip(aligns, want_al, wavs):
        frames = int(cfg.feat_extract_output_lengths(len(w)))
        if want.shape[0] == 0:  # no phoneme decoded: an empty matrix
            al_agree = min(al_agree, float(got.size == 0
                                           and want.shape == (0, frames)))
            continue
        if got.shape != want.shape or want.shape[1] != frames:
            al_agree = 0.0
            continue
        al_agree = min(al_agree, float(np.mean(
            got.argmax(0) == want.argmax(0))))
        al_err = max(al_err, float(np.abs(got - want).max()))
    log(f"  9c CLI subprocesses (both together) in {cli_s:.1f} s on {card}: "
        f"{len(lines)} JSON lines over the APTAI run against predict_batch "
        f"in the same batches: Pearson min {worst_r:.6f}, frame agreement "
        f"{worst_a:.4%}, TV max_abs_err {worst_err:.3e}; --task alignment "
        f"over the FORCE run: (phonemes, frames) "
        f"{[tuple(a.shape) for a in want_al]}, against get_alignment: "
        f"argmax agreement {al_agree:.4%}, max_abs_err {al_err:.3e}")
    if not (len(lines) == 8 and worst_r >= 0.999 and worst_a >= 0.99
            and len(aligns) == 3 and al_agree >= 0.99):
        raise AssertionError("9c: the CLI's output is wrong")


def phase_inference(root, aptai_ckpt, force_ckpt, card):
    log("== phase 9: the inference surfaces at full width")
    t_phase = time.perf_counter()
    streams = phase_streaming(card)
    http_one = phase_http(aptai_ckpt, card)
    phase_cli(root, aptai_ckpt, force_ckpt, card)
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return streams, http_one


# -- phase 10 -----------------------------------------------------------------

SEVEN_CONVS = dict(conv_dim=(128,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                   conv_stride=(5, 2, 2, 2, 2, 2, 2))


def pretrain_batch(cfg, b: int, seconds: int, seed: int = 0, lengths=None):
    """``train_batch``'s audio (silenced past ``lengths`` in samples when
    given) with the Gumbel temperature at the schedule's top, 2.0."""
    base = train_batch(cfg, b, seconds, seed)
    audio, lens = base["audio"], base["audio_lengths"]
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        for i, n in enumerate(lens):
            audio[i, n:] = 0.0
    return {"audio": audio, "audio_lengths": lens,
            "gumbel_temp": np.full(b, 2.0, np.float32)}


def fixed_draws(cfg, batch, num_negatives, seed):
    """The span mask (prob 0.65, span 10, at least 2) and the distractor
    indices of ``batch`` from generators seeded with ``seed``, on the
    card: one set of draws for two runs that must agree."""
    lengths = torch.as_tensor(batch["audio_lengths"]).cuda()
    n = batch["audio"].shape[1]
    t = int(cfg.feat_extract_output_lengths(n))
    frames = cfg.feat_extract_output_lengths(lengths)
    gen = torch.Generator(lengths.device).manual_seed(seed)
    mask = w2v.compute_time_mask(gen, frames, t, 0.65, 10, 2)
    idx = sample_negative_indices(gen, len(lengths), t, frames,
                                  num_negatives)
    return mask, idx


def _codes(model, audio, lengths, mask, noise=None):
    """(B, T, G) quantizer codes of ``model``'s features: the argmax of
    the logits (plus ``noise``), as the forward picks them."""
    with torch.no_grad():
        extract = model.wav2vec2(audio, lengths, time_mask=mask)[2].float()
        q = model.quantizer
        logits = q.weight_proj(extract).view(*extract.shape[:2],
                                             q.num_groups, q.num_vars)
        if noise is not None:
            logits = logits + noise
    return logits.argmax(-1).numpy()


def steer_distractors(codes, idx, frames, collide_first):
    """``idx`` with every distractor that shares its positive's codes moved
    to the first frame that does not (so no collision is decided by the
    straight-through rows' rounding), or, with ``collide_first``, item 0
    frame 0's distractors all on frames with its codes."""
    idx = idx.copy()
    b, t, _ = idx.shape
    if collide_first:
        same = [j for j in range(1, frames[0])
                if (codes[0, j] == codes[0, 0]).all()]
        if not same:
            raise AssertionError("no frame shares frame 0's codes")
        idx[0, 0] = np.resize(same, idx.shape[-1])
        return idx
    for bi in range(b):
        for ti in range(t):
            hit = (codes[bi, idx[bi, ti]] == codes[bi, ti]).all(-1)
            if hit.any():
                other = [j for j in range(frames[bi])
                         if not (codes[bi, j] == codes[bi, ti]).all()]
                idx[bi, ti, hit] = other[0]
    return idx


def check_small_pretrain_reference(device: str = "cuda"):
    """10a: a small float32 ``Wav2Vec2Pretrain`` (head dim 64, G 2 x V 320,
    K 100, dropout off) on the card against the same model on the CPU, the
    draws given: in ``train()`` (Gumbel noise, straight-through; no
    distractor shares its positive's codes) and in ``eval()`` with every
    distractor of one frame equal to its positive. The eight outputs
    within 1e-4 relative (the counts exact), the gradients within 1e-4
    relative L2 and cosine 1 - 1e-8."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, mask_time_prob=0.0,
                      apply_spec_augment=True, **SEVEN_CONVS, **NO_DROP)
    lengths = np.array([32_000, 21_000, 9_000], np.int32)
    batch = pretrain_batch(cfg, 3, 2, seed=10, lengths=lengths)
    frames = cfg.feat_extract_output_lengths(lengths)
    t = int(cfg.feat_extract_output_lengths(batch["audio"].shape[1]))
    rng = np.random.default_rng(10)
    mask = torch.from_numpy(rng.random((3, t)) < 0.5)
    mask[0, 0] = True
    noise = torch.from_numpy(rng.gumbel(size=(3, t, 2, 320)).astype(
        np.float32))
    idx = negative_indices_from_uniform(
        torch.from_numpy(rng.random((3, t, 100), np.float32)),
        torch.from_numpy(frames)).numpy()
    audio = torch.from_numpy(batch["audio"])
    lens = torch.from_numpy(lengths)
    for train in (True, False):
        model = random_wav2vec2_pretrain(cfg, seed=1)
        codes = _codes(model, audio, lens, mask, noise if train else None)
        case_idx = torch.from_numpy(steer_distractors(
            codes, idx, frames, collide_first=not train))
        runs = {}
        for dev in ("cpu", device):
            m = random_wav2vec2_pretrain(cfg, seed=1).to(dev).train(train)
            out = m(audio.to(dev), lens.to(dev), mask.to(dev), 1.5,
                    gumbel_noise=noise.to(dev),
                    negative_indices=case_idx.to(dev))
            out["loss"].backward()
            runs[dev] = ({k: v.detach().cpu() for k, v in out.items()},
                         ) + flat_grads(m)
        (oc, gc, fc), (og, gg, fg) = runs["cpu"], runs[device]
        mode = "train()" if train else "eval(), frame 0's distractors all " \
                                       "colliding"
        log(f"  10a small f32 Wav2Vec2Pretrain, {mode}, card vs CPU: "
            + ", ".join(f"{k} {float(og[k]):.6f} vs {float(oc[k]):.6f}"
                        for k in pretrain.VAL_KEYS)
            + f", num_masked {int(og['num_masked'])}")
        for k, v in oc.items():
            if k in ("num_masked", "frame_lengths"):
                ok = torch.equal(og[k], v)
            else:
                ok = abs(float(og[k]) - float(v)) <= 1e-4 * abs(float(v))
            if not ok:
                raise AssertionError(f"10a: {k} on the card disagrees with "
                                     "the CPU's")
        compare_grads(f"10a small f32 pretrain gradients, {mode}, card vs "
                      f"CPU", gg, fg, gc, fc, max_rel=1e-4,
                      min_cos=0.99999999)


def check_pretrain_outputs(out, gv, what):
    vals = {k: float(v) for k, v in out.items()}
    if not (all(np.isfinite(v) for v in vals.values())
            and 0.0 <= vals["contrastive_accuracy"] <= 1.0
            and 0.0 < vals["codebook_perplexity"] <= gv):
        raise AssertionError(f"{what}: outputs out of range {vals}")
    return vals


def pretrain_kernels_vs_plain(model, cfg, batch, layers, what, seed):
    """The same batch in ``eval()`` (no dropout, argmax quantization) on
    fixed draws, through the kernels and through plain attention: the
    encoder gradients under phase 5's gates."""
    mask, idx = fixed_draws(cfg, batch, model.num_negatives, seed)
    model.eval()
    try:
        grads_kernels_vs_plain(model, [
            torch.as_tensor(batch["audio"]).cuda(),
            torch.as_tensor(batch["audio_lengths"]).cuda(), mask, 1.0, None,
            None, idx], layers, what)
    finally:
        model.train()


def phase_pretrain_step(card):
    """10b and 10c: the full-width pretraining step at 8 x 5 s and at
    4 x 15 s through ``TrainStep(..., pretrain_loss_fn())``."""
    cfg = Wav2Vec2Config(dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = random_wav2vec2_pretrain(cfg, seed=0)
    gv = model.quantizer.num_groups * model.quantizer.num_vars
    step = TrainStep(model, torch_adam(model), pretrain.pretrain_loss_fn())
    log(f"  full-width Wav2Vec2Pretrain (bf16 compute, float32 masters, "
        f"G 2 x V 320, d = P = 256, K {model.num_negatives}, seed 0) on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    batch = pretrain_batch(cfg, 8, 5)
    b, samples = batch["audio"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0, counts = checked_first_step(step, batch, layers)
    timed_steps(step, batch, 1)  # the second warm-up step
    reset_counts()
    times, m = timed_steps(step, batch, 5)
    counts5 = read_counts()
    sec = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = training_step_flops(b * encoder_flops(cfg, samples)["total"])
    util = mfu(flops, sec, device_peak_tflops())
    vals = check_pretrain_outputs(m, gv, "10b")
    log(f"  10b step times (s): {[round(x, 5) for x in times]}; launches "
        f"over them {counts5}; last step {vals}")
    log(f"  10b {b * samples / SAMPLE_RATE / sec:.1f} train audio-s/s, "
        f"{sec * 1e3:.2f} ms per step, MFU "
        f"{'not known for this card' if util is None else f'{util:.4f}'} "
        f"({flops / 1e12:.2f} TFLOP per step: 3x the encoder's forward, FE "
        f"included; the head's projections, quantizer and logits, under "
        f"0.5 %, left out) on {card}; peak memory {peak:.2f} GiB")
    if any(counts5[n] != 5 * layers for n in FLASH) \
            or counts5["fused_conv_ln_gelu"]:
        raise AssertionError(f"10b launches over 5 steps: {counts5}")
    profile_breakdown(lambda: step(batch, 1e-5), "one pretrain step", top=15)
    pretrain_kernels_vs_plain(
        model, cfg, batch, layers,
        "10b pretrain encoder gradients (FE included), kernels vs plain", 3)
    torch.cuda.empty_cache()

    # 10c: 4 x 15 s, ragged
    batch15 = pretrain_batch(cfg, 4, 15, seed=1,
                             lengths=[240_000, 200_000, 160_000, 120_000])
    t15 = int(cfg.feat_extract_output_lengths(240_000))
    torch.cuda.reset_peak_memory_stats()
    loss15, counts15 = checked_first_step(step, batch15, layers)
    times15, m15 = timed_steps(step, batch15, 2)
    peak15 = torch.cuda.max_memory_allocated() / 2**30
    vals15 = check_pretrain_outputs(m15, gv, "10c")
    flops15 = training_step_flops(sum(
        encoder_flops(cfg, int(n))["total"]
        for n in batch15["audio_lengths"]))
    util15 = mfu(flops15, times15[-1], device_peak_tflops())
    audio15 = float(np.sum(batch15["audio_lengths"])) / SAMPLE_RATE
    log(f"  10c 4 x 15 s (T = {t15}, lengths 15/12.5/10/7.5 s): step times "
        f"(s) {[round(x, 5) for x in times15]}, "
        f"{audio15 / times15[-1]:.1f} train audio-s/s of valid audio, MFU "
        f"{'not known for this card' if util15 is None else f'{util15:.4f}'}"
        f" (the valid audio's encoder FLOPs x 3), peak memory "
        f"{peak15:.2f} GiB on {card}; last step {vals15}")
    pretrain_kernels_vs_plain(
        model, cfg, batch15, layers,
        "10c pretrain encoder gradients at 4 x 15 s, kernels vs plain", 4)
    del step, model
    torch.cuda.empty_cache()
    return ({k: counts[k] for k in COUNTED}, {k: counts15[k] for k in COUNTED})


def phase_pretrain_trainer(root, card):
    """10d: ``pretrain.main`` through its argv (full width, laptop, batch
    4) on a synthetic CommonPhone corpus, then ``build_pr_model`` grafting
    its best checkpoint's encoder: every tensor bit for bit."""
    cp_csv = make_synthetic_commonphone(root / "cp_pretrain", 8, 2, 2)
    exp = root / "pretrain"
    argv = ["--exp_dir", str(exp), "--audio_csv_path", str(cp_csv),
            "--laptop", "--batch_size", "4", "--platform", PLATFORM]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FitProbe(pretrain) as probe:
        history, model = pretrain.main(argv)
    run_s = time.perf_counter() - t0
    rec = probe.calls[0]
    steps = history[0]["train_steps"]
    counts = rec["epochs"][0]
    layers = model.cfg.num_hidden_layers
    val = {f"val_{k}": history[0][f"val_{k}"] for k in pretrain.VAL_KEYS}
    missing = [f for f in ("experiment_args.json", "metrics.jsonl",
                           "best-model-ckpt/params.msgpack",
                           "best-model-ckpt/model_cfg.json",
                           "last-model-ckpt/opt_state.msgpack")
               if not (exp / f).exists()]
    log(f"  10d pretrain.main {' '.join(argv[4:])}: {run_s:.1f} s, {steps} "
        f"step(s), launches a step {per_step(counts, steps)}, train loss "
        f"{history[0]['mean_train_loss']}, {val}; checkpoints "
        f"{ckpt_seconds([rec]):.2f} s, run directory {dir_gb(exp):.2f} GB; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    if missing or steps != 1 or not (
            all(counts[k] == layers for k in FLASH)
            and counts["fused_conv_ln_gelu"] == 0
            and np.isfinite(history[0]["mean_train_loss"])
            and all(np.isfinite(v) for v in val.values())):
        raise AssertionError(f"10d: missing {missing}, launches {counts} or "
                             "a non-finite loss")
    del model, rec, probe
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pr_model, _ = build_pr_model(
        PRConfig(platform=PLATFORM, pretrained_checkpoint=str(exp)),
        {f"p{i}": i for i in range(46)})
    best = read_params(exp / "best-model-ckpt")
    got = pr_model.wav2vec2.state_dict()
    same = all(torch.equal(v, best[f"wav2vec2.{k}"]) for k, v in got.items())
    log(f"  10d build_pr_model(pretrained_checkpoint=<the run>) in "
        f"{time.perf_counter() - t0:.1f} s: {len(got)} encoder tensors "
        f"(masked_spec_embed {'masked_spec_embed' in got}) equal to the best "
        f"checkpoint's bit for bit: {same}")
    if not (same and "masked_spec_embed" in got):
        raise AssertionError("10d: the graft did not splice the pretrained "
                             "encoder")
    shutil.rmtree(exp)
    return counts, steps


def phase_pretrain(card, root):
    log("== phase 10: wav2vec2 pretraining at full width")
    t_phase = time.perf_counter()
    check_small_pretrain_reference()
    step_counts, step15_counts = phase_pretrain_step(card)
    trainer_counts, trainer_steps = phase_pretrain_trainer(root, card)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return step_counts, step15_counts, (trainer_counts, trainer_steps)


# -- phase 11 -----------------------------------------------------------------

# where phase 11 exports, loads and serves its bundles ("cpu" rehearses
# 11b-11d on the CPU)
BUNDLE_DEVICE = "cuda"
# the aptai_torch ops, by the name the exported graphs give them
OP_NAMES = {"flash_attn_fwd": "aptai_torch.flash_fwd.default",
            "fused_conv_ln_gelu": "aptai_torch.fused_conv_ln_gelu.default",
            "packed_lstm": "aptai_torch.packed_lstm.default",
            "beam_decode": "aptai_torch.beam_decode.default"}


def graph_ops(bundle):
    """{call target: count} of a loaded bundle's exported graph."""
    ops = {}
    for node in bundle.program.graph.nodes:
        if node.op == "call_function":
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def check_graph(bundle, what, layers, fused=0, lstm=0, beam=0):
    """The exported graph holds the kernel ops (the flash forward once a
    layer, the fused conv, FORCE's two serving ops) and no packing or
    inlined plain attention (its row max), and none of torch.export's
    dtype assertions (``infer/export.py`` erases them)."""
    ops = graph_ops(bundle)
    want = {OP_NAMES["flash_attn_fwd"]: layers,
            OP_NAMES["fused_conv_ln_gelu"]: fused,
            OP_NAMES["packed_lstm"]: lstm, OP_NAMES["beam_decode"]: beam}
    got = {k: ops.get(k, 0) for k in want}
    bad = sorted(k for k in ops if "pack_padded" in k or "amax" in k
                 or "flash_fwd_lse" in k or "flash_bwd" in k
                 or "_assert_tensor_metadata" in k)
    if got != want or bad:
        raise AssertionError(f"11: {what}'s graph holds {got} (want {want}), "
                             f"and {bad}")
    return sum(ops.values())


def opcheck_cases(gen):
    """(name, op, args) of every aptai_torch op at small shapes on the
    card, bf16 and float32 where the kernel takes both."""
    from aptai_tpu_torch.decode.device import beam_decode
    from aptai_tpu_torch.ops.lstm import packed_lstm

    cases = []
    lens = torch.tensor([65, 17], dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q, k, v = _qkv(gen, 2, 2, 65, dtype, model_layout=True)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        out, lse = attention.flash_fwd_lse(q, k, v, lens)
        _, delta = attention.flash_bwd_dq(q, k, v, out, lse, dout, lens)
        cases += [
            (f"flash_fwd {tag}", attention.flash_fwd, (q, k, v, lens)),
            (f"flash_fwd_lse {tag}", attention.flash_fwd_lse,
             (q, k, v, lens)),
            (f"flash_bwd_dq {tag}", attention.flash_bwd_dq,
             (q, k, v, out, lse, dout, lens)),
            (f"flash_bwd_dkv {tag}", attention.flash_bwd_dkv,
             (q, k, v, dout, lse, delta, lens))]
        x, w, b, ln_w, ln_b = fused_operands(gen, 2, 263, 128, 128, 3, dtype)
        cases.append((f"fused_conv_ln_gelu {tag}",
                      fused_conv.fused_conv_ln_gelu_op,
                      (x, w, b, ln_w, ln_b, 2, 1e-5)))
    h = 16
    weights = [torch.randn(shape, generator=gen, device="cuda") * 0.3
               for shape in ((4 * h, 8), (4 * h, h), (4 * h,), (4 * h,))] * 2
    cases.append(("packed_lstm f32", packed_lstm, (
        torch.randn((3, 9, 8), generator=gen, device="cuda"),
        torch.tensor([9, 4, 0], dtype=torch.int32, device="cuda"), weights,
        True)))
    log_probs = torch.log_softmax(
        3 * torch.randn((2, 30, 12), generator=gen, device="cuda"), -1)
    cases.append(("beam_decode f32", beam_decode, (
        log_probs, torch.tensor([30, 17], dtype=torch.int32, device="cuda"),
        0, 10, 50.0, 16)))
    return cases


def phase_opcheck():
    """11a: ``torch.library.opcheck`` on every op with CUDA inputs: the
    schema, the fake implementation's shapes, dtypes and strides against
    the kernels' outputs, and the op under AOT dispatch."""
    gen = torch.Generator("cuda").manual_seed(11)
    t0 = time.perf_counter()
    names = []
    for name, op, args in opcheck_cases(gen):
        result = torch.library.opcheck(op, args)
        if set(result.values()) != {"SUCCESS"}:
            raise AssertionError(f"11a: opcheck of {name}: {result}")
        names.append(name)
    log(f"  11a opcheck on the card, every test SUCCESS for {len(names)} "
        f"cases ({', '.join(names)}) in {time.perf_counter() - t0:.1f} s")


def op_host_cost(card):
    """11a: host time of one attention call in inference mode at a
    request's shape (1, 16, 49, 64), through the op
    (``multi_head_attention_bhtd``) and through the kernel's wrapper
    alone, 2000 calls each after 200, in turns op, wrapper, wrapper, op:
    the dispatcher's cost a call (a record, not a gate)."""
    gen = torch.Generator("cuda").manual_seed(12)
    q, k, v = _qkv(gen, 1, 16, 49, torch.bfloat16, model_layout=True)
    lens = torch.tensor([49], dtype=torch.int32, device="cuda")
    fns = {"op": lambda: attention.multi_head_attention_bhtd(q, k, v, lens),
           "wrapper": lambda: attention.flash_attention_bhtd_cuda(q, k, v,
                                                                  lens)}
    turns = []
    with torch.inference_mode():
        for who in ("op", "wrapper", "wrapper", "op"):
            for _ in range(200):
                fns[who]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fns[who]()
            turns.append((who, (time.perf_counter() - t0) / 2000 * 1e6))
            torch.cuda.synchronize()
    log("  11a host time of one attention call, inference mode, (1, 16, 49, "
        "64) bf16, in turns: " + ", ".join(f"{who} {us:.1f} us"
                                           for who, us in turns)
        + f" on {card}")


def _bundle_gap(got, want, n_frames, frame_keys):
    """Largest |Δ| of the float outputs over the valid frames relative to
    the largest |want| there, and whether every integer output agrees."""
    err, same = 0.0, True
    for k, w in want.items():
        g = got[k]
        for b, n in enumerate(n_frames):
            gb, wb = (g[b, :n], w[b, :n]) if k in frame_keys else (g[b],
                                                                   w[b])
            if w.dtype.kind == "f":
                err = max(err, _rel_err(torch.from_numpy(gb),
                                        torch.from_numpy(wb))[1])
            else:
                same &= bool(np.array_equal(gb, wb))
    return err, same


FRAME_KEYS = ("tvs_pred", "phn_fc_pred", "pred_frame_phns", "phoneme_logits")


def phase_small_bundles(root):
    """11b: small float32 bundles exported on the card (FORCE greedy and
    ``beam_device``, W2V2PR with the fused feature extractor), each
    against the live predictor on the same requests (the same padded
    shape: 4 x 3 s) and its graph checked; then one bundle exported for
    ``("cuda", "cpu")``, loaded on the CPU in a fresh process with CUDA
    hidden, against the CPU predictor."""
    from aptai_tpu_torch.infer.export import (load_serving_bundle,
                                              save_serving_bundle)
    from aptai_tpu_torch.infer.serve import KIND_FIELDS

    rng = np.random.default_rng(12)
    wavs = [(rng.standard_normal(int(s * SAMPLE_RATE)) * 0.1).astype(
        np.float32) for s in (3.0, 1.4, 2.2, 0.7)]
    force_cfg, pr_cfg = small_force_config(), small_pr_config()
    cases = (
        ("force_aptai greedy", random_force_aptai(force_cfg, seed=3),
         "predict", ForceAPTAIPredictor, dict(lstm=1)),
        ("force_aptai beam_device", random_force_aptai(
            force_cfg, seed=3, decode_method="beam_device"), "predict",
         ForceAPTAIPredictor, dict(lstm=1, beam=1)),
        ("w2v2_pr fused FE", random_w2v2_pr(pr_cfg, seed=3), "encode",
         W2V2PRPredictor, dict(fused=2)))
    for name, model, method, cls, ops in cases:
        kind = "w2v2_pr" if method == "encode" else "force_aptai"
        fields = KIND_FIELDS[kind]
        t0 = time.perf_counter()
        path = save_serving_bundle(
            root / name.replace(" ", "_"), model, method=method, batch=4,
            seconds=3.0, fields=fields, platforms=(BUNDLE_DEVICE,),
            kind=kind)
        export_s = time.perf_counter() - t0
        bundle = load_serving_bundle(path, device=BUNDLE_DEVICE)
        layers = model.cfg.num_hidden_layers if kind == "w2v2_pr" else \
            model.w2v2_pr.cfg.num_hidden_layers
        n_ops = check_graph(bundle, name, layers, **ops)
        pred = cls(model, device=BUNDLE_DEVICE)
        live = (pred.encode_batch if kind == "w2v2_pr"
                else pred.predict_batch)(wavs, fields=fields)
        got, want = fetch_outputs(bundle.predict_batch(wavs)), \
            fetch_outputs(live)
        err, same = _bundle_gap(got, want, want["frame_lengths"], FRAME_KEYS)
        log(f"  11b small f32 {name}: exported on {BUNDLE_DEVICE} in "
            f"{export_s:.1f} s, {n_ops} graph calls ({ops} + {layers} flash "
            f"forward); against the live predictor, same requests: max rel "
            f"err {err:.2e}, integer outputs equal {same}")
        if err > F32_TOL or not same:
            raise AssertionError(f"11b: the {name} bundle disagrees with the "
                                 "live predictor")

    model = random_force_aptai(force_cfg, seed=4, decode_method="beam_device")
    path = save_serving_bundle(
        root / "force_cuda_cpu", model, batch=4, seconds=3.0,
        fields=KIND_FIELDS["force_aptai"], platforms=(BUNDLE_DEVICE, "cpu"),
        kind="force_aptai")
    np.savez(root / "cpu_wavs.npz", *wavs)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _CPU_LOAD, str(path), str(root)],
        cwd=root, env=dict(_package_env(), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"11b: loading the bundle in a process without "
                             f"CUDA failed:\n{res.stderr[-3000:]}")
    info = json.loads(res.stdout.strip().splitlines()[-1])
    with np.load(root / "cpu_out.npz") as z:
        got = {k: z[k] for k in z.files}
    want = fetch_outputs(ForceAPTAIPredictor(model, device="cpu")
                         .predict_batch(wavs, fields=KIND_FIELDS[
                             "force_aptai"]))
    err, same = _bundle_gap(got, want, want["frame_lengths"], FRAME_KEYS)
    log(f"  11b FORCE beam_device bundle for ('{BUNDLE_DEVICE}', 'cpu'), "
        f"traced on {BUNDLE_DEVICE}, loaded in a fresh process without "
        f"CUDA (cuda available {info['cuda']}; process {child_s:.1f} s, "
        f"load {info['load_s']:.1f} s, weights on {info['placed']}): "
        f"against the CPU predictor max rel err {err:.2e}, integer outputs "
        f"equal {same}; kernel launches {info['launches']}")
    if (err > F32_TOL or not same or info["cuda"]
            or info["placed"] != ["cpu"] or any(info["launches"].values())):
        raise AssertionError("11b: the bundle loaded without CUDA disagrees "
                             "with the CPU predictor")


def _package_env():
    """The environment with this checkout first on ``PYTHONPATH``."""
    here = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(here), os.environ.get("PYTHONPATH")) if p))


# 11b's child: loads a bundle on the CPU with CUDA hidden and runs
# <dir>/cpu_wavs.npz through it into <dir>/cpu_out.npz
_CPU_LOAD = r"""
import json, sys, time
from pathlib import Path
import numpy as np
import torch
from aptai_tpu_torch.infer.export import load_serving_bundle
from aptai_tpu_torch.infer.transfer import fetch_outputs
from aptai_tpu_torch.ops import attention, fused_conv

root = Path(sys.argv[2])
t0 = time.perf_counter()
bundle = load_serving_bundle(sys.argv[1], device="cpu")
load_s = time.perf_counter() - t0
with np.load(root / "cpu_wavs.npz") as z:
    wavs = [z[f"arr_{i}"] for i in range(len(z.files))]
np.savez(root / "cpu_out.npz", **fetch_outputs(bundle.predict_batch(wavs)))
launches = {f.__name__: f.launches for f in (
    attention.flash_attention_bhtd_cuda, attention.flash_attention_bwd_dq_cuda,
    attention.flash_attention_bwd_dkv_cuda, fused_conv.fused_conv_ln_gelu_cuda)}
print(json.dumps({"cuda": torch.cuda.is_available(), "load_s": load_s,
                  "placed": sorted({str(t.device) for t in
                                    bundle.program.state_dict.values()}),
                  "launches": launches}))
"""


def export_requests(seed: int, n: int = 16):
    """``n`` requests of 1-10 s cut from the synthetic corpora's audio."""
    recording = synthetic_recording(120.0, seed=seed)
    rng = np.random.default_rng(seed)
    secs = rng.uniform(1.0, 10.0, n)
    starts = rng.integers(0, len(recording) - 10 * SAMPLE_RATE, n)
    return [recording[st:st + int(x * SAMPLE_RATE)]
            for x, st in zip(secs, starts)]


def bundle_vs_live(kind, bundle, live, wavs, what):
    """One bundle batch of ``wavs`` against the live predictor on the same
    requests, under the serving gates of phases 3 and 6: per-TV Pearson
    (the logits' for W2V2PR) ≥ 0.999 and frame agreement ≥ 99 % over the
    valid frames of every request together; FORCE's decoded sequences no
    further from the live ones than the live ones on the waveforms x
    (1 + 2^-9) are (one point of slack). Returns the bundle batch's
    launches."""
    reset_counts()
    got = fetch_outputs(bundle.predict_batch(wavs))
    counts = read_counts()
    want = fetch_outputs(live(wavs))
    n = want["frame_lengths"]
    if not np.array_equal(got["frame_lengths"], n):
        raise AssertionError(f"11c: {what} frame counts differ")
    keys = [k for k in FRAME_KEYS if k in want]
    cat = lambda out: {k: np.concatenate([out[k][b, :n[b]]
                                          for b in range(len(wavs))])
                       for k in keys}
    r, agree = served_agreement(cat(got), cat(want))
    text = (f"per-{'logit' if kind == 'w2v2_pr' else 'TV'} Pearson min "
            f"{r:.6f}, frame agreement {agree:.4%}")
    ok = r >= 0.999 and agree >= 0.99
    if kind == "force_aptai":
        seqs = lambda out: [out["pred_ctc_phn_seq"][b, :out[
            "phn_seq_lengths"][b]].tolist() for b in range(len(wavs))]
        nudged = fetch_outputs(live([w * np.float32(1 + 2 ** -9)
                                     for w in wavs]))
        ter, ter_n = (compare_seqs(seqs(got), seqs(want)),
                      compare_seqs(seqs(nudged), seqs(want)))
        text += (f", sequences identical on "
                 f"{sum(a == b for a, b in zip(seqs(got), seqs(want)))} of "
                 f"{len(wavs)}, token error rate {ter:.4%} (noise floor "
                 f"{ter_n:.4%})")
        ok &= ter <= ter_n + 0.01
    log(f"  11c {what}, 16 requests of 1-10 s in one bundle batch against "
        f"the live predictor: {text}; launches {counts}")
    if not ok:
        raise AssertionError(f"11c: the {what} bundle disagrees with the "
                             "live predictor")
    return counts


def bundle_throughput(bundle, live, card, what):
    """Bundle and live audio-s/s at 16 x 10 s, alternated live, bundle,
    bundle, live (records, not claims); then one profiled batch of each:
    device kernel time against wall time, and host aten calls."""
    rng = np.random.default_rng(13)
    big = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
           for _ in range(16)]
    runs = {"live": [], "bundle": []}
    for who in ("live", "bundle", "bundle", "live"):
        fn = (lambda: bundle.predict_batch(big)) if who == "bundle" else \
            (lambda: live(big))
        runs[who].append(float(np.median(timed_batches(fn, n=3, warmup=1))))
    text = ", ".join(f"{who} {160 / t:.1f} audio-s/s ({t * 1e3:.2f} ms)"
                     for who in ("live", "bundle", "bundle", "live")
                     for t in [runs[who].pop(0)])
    log(f"  11c {what} at 16 x 10 s, median of 3 batches each, in turns: "
        f"{text} on {card}")
    for who, fn in (("bundle", lambda: bundle.predict_batch(big)),
                    ("live", lambda: live(big))):
        busy, wall, prof = profile_breakdown(fn, f"one {who} batch ({what})",
                                             top=0)
        ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
        top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:4]
        log(f"    {who}: {sum(e.count for e in ops)} host aten calls, "
            f"{sum(e.self_cpu_time_total for e in ops) / 1e3:.2f} ms of "
            f"their self CPU time (" + ", ".join(
                f"{e.key} {e.count}x {e.self_cpu_time_total / 1e3:.2f} ms"
                for e in top) + f"); {threading.active_count()} threads")


def export_cli(ckpt, out, card):
    """``export.main`` over a trainer checkpoint (bf16, 16 x 10 s): its
    JSON line, the export and load seconds, the bundle's bytes."""
    from aptai_tpu_torch.infer import export

    argv = [str(ckpt), str(out), "--batch", "16", "--seconds", "10",
            "--dtype", "bfloat16", "--platforms", BUNDLE_DEVICE]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = export.main(argv)
    export_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"11c: aptai-torch-export {ckpt} exited {rc}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    t0 = time.perf_counter()
    bundle = export.load_serving_bundle(out, device=BUNDLE_DEVICE)
    load_s = time.perf_counter() - t0
    log(f"  11c aptai-torch-export {line['kind']} ({' '.join(argv[2:])}): "
        f"{export_s:.1f} s, {line['bytes']} bytes ({line['bytes'] / 2**30:.2f}"
        f" GiB), loaded on {BUNDLE_DEVICE} in {load_s:.1f} s; {card}")
    return line, bundle


def phase_export_cli(root, aptai_ckpt, force_ckpt, card):
    """11c: ``aptai-torch-export`` over phase 8's APTAI and FORCE
    checkpoints, and a full-width W2V2PR bundle with the fused feature
    extractor: each bundle batch against the live predictor, its
    launches, and audio-s/s beside the live predictor's. Returns
    {path: launches of one bundle batch} and the APTAI bundle's
    directory, live predictor and vocabulary."""
    from aptai_tpu_torch.infer.export import (load_serving_bundle,
                                              save_serving_bundle)
    from aptai_tpu_torch.infer.serve import KIND_FIELDS

    cfg = Wav2Vec2Config(dtype="bfloat16")
    layers = cfg.num_hidden_layers
    launches = {}
    for kind, ckpt, seed in (("aptai", aptai_ckpt, 14),
                             ("force_aptai", force_ckpt, 15)):
        out = root / f"bundle_{kind}"
        line, bundle = export_cli(ckpt, out, card)
        check_graph(bundle, f"the {kind} bundle", layers,
                    lstm=int(kind == "force_aptai"))
        _, model, vocab = load_model(ckpt, dtype="bfloat16")
        pred = (APTAIPredictor if kind == "aptai" else
                ForceAPTAIPredictor)(model, device=BUNDLE_DEVICE)
        del model
        live = lambda wavs: pred.predict_batch(wavs,
                                               fields=KIND_FIELDS[kind])
        counts = bundle_vs_live(kind, bundle, live, export_requests(seed),
                                f"{kind} bundle")
        want = {"flash_attn_fwd": layers, "flash_attn_bwd_dq": 0,
                "flash_attn_bwd_dkv": 0, "fused_conv_ln_gelu": 0}
        if counts != want:
            raise AssertionError(f"11c: a {kind} bundle batch launched "
                                 f"{counts}, want {want}")
        bundle_throughput(bundle, live, card, f"{kind} bundle")
        launches[f"bundle_{kind}"] = counts
        if kind == "aptai":  # 11d serves it beside this predictor
            aptai = (out, pred, vocab)
        del bundle, pred
        torch.cuda.empty_cache()

    pr_cfg = dataclasses.replace(cfg, fused_feature_extractor=True)
    model = random_w2v2_pr(pr_cfg, seed=0)
    t0 = time.perf_counter()
    path = save_serving_bundle(
        root / "bundle_w2v2_pr", model, method="encode", batch=16,
        seconds=10.0, fields=KIND_FIELDS["w2v2_pr"],
        platforms=(BUNDLE_DEVICE,), kind="w2v2_pr",
        vocab={f"p{i}": i for i in range(pr_cfg.vocab_size)})
    export_s = time.perf_counter() - t0
    bundle = load_serving_bundle(path, device=BUNDLE_DEVICE)
    check_graph(bundle, "the W2V2PR bundle", layers, fused=6)
    pred = W2V2PRPredictor(model, device=BUNDLE_DEVICE)
    del model
    log(f"  11c full-width W2V2PR (fused FE, bf16, seed 0) exported with "
        f"save_serving_bundle in {export_s:.1f} s")
    counts = bundle_vs_live(
        "w2v2_pr", bundle,
        lambda wavs: pred.encode_batch(wavs, fields=("phoneme_logits",)),
        export_requests(16), "W2V2PR fused-FE bundle")
    want = {"flash_attn_fwd": layers, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0, "fused_conv_ln_gelu": 6}
    if counts != want:
        raise AssertionError(f"11c: a W2V2PR bundle batch launched {counts},"
                             f" want {want}")
    launches["bundle_w2v2_pr_fused_fe"] = counts
    del bundle, pred
    torch.cuda.empty_cache()
    return launches, aptai


def phase_bundle_http(aptai_bundle, live_pred, vocab, card):
    """11d: ``build_app`` over the APTAI bundle behind the native transport:
    8 ``/v1/predict`` requests against ``ServingApp.handle`` of the live
    app over the checkpoint's predictor (as ``build_app`` serves it,
    batch 16, without a streamer; phase 9b's gates), an over-cap request's
    400, ``/v1/stream`` without a streamer, ``/healthz``. Returns the
    launches of one request alone."""
    from aptai_tpu_torch.infer.serve import KIND_FIELDS, ServingApp

    t0 = time.perf_counter()
    app = build_app(str(aptai_bundle), device=BUNDLE_DEVICE)
    build_s = time.perf_counter() - t0
    live = ServingApp(MicroBatcher(live_pred.predict_batch,
                                   max_batch_size=16,
                                   fields=KIND_FIELDS["aptai"]).start(),
                      "aptai", vocab=vocab)
    layers = Wav2Vec2Config().num_hidden_layers
    srv = make_native_server(app, "127.0.0.1", 0)
    try:
        port = srv.port
        reqs = [(w.tobytes(), {"Content-Type": "application/octet-stream"})
                for w in export_requests(17, 8)]
        reset_counts()
        results = [request_once(port, "POST", "/v1/predict", *reqs[0])[::2]]
        one = read_counts()
        results += [request_once(port, "POST", "/v1/predict", *r)[::2]
                    for r in reqs[1:]]
        direct = [live.handle("POST", "/v1/predict", r[1], r[0])
                  for r in reqs]
        r, a, single = check_http_answers(results, direct, "bundle")
        over = request_once(port, "POST", "/v1/predict",
                            np.zeros(11 * SAMPLE_RATE, np.float32).tobytes(),
                            {})
        stream = request_once(port, "POST", "/v1/stream",
                              np.zeros(SAMPLE_RATE, np.float32).tobytes(), {})
        health = request_once(port, "GET", "/healthz", None, {})
        h = json.loads(health[2]) if health[0] == 200 else {}
        over_msg = json.loads(over[2]).get("error", "")
        log(f"  11d build_app over the APTAI bundle (warm-up included) in "
            f"{build_s:.1f} s, native transport: 8 /v1/predict requests "
            f"against the live app's handle: per-TV Pearson min {r:.6f} "
            f"(one response's min {single:.6f}), frame agreement {a:.4%}; "
            f"one request alone launched {one}; 11 s: {over[0]} "
            f"{over_msg!r}; /v1/stream {stream[0]}; /healthz {health[0]} "
            f"bundle {h.get('bundle')!r} platforms {h.get('platforms')} "
            f"streaming {h.get('streaming')} on {card}")
        if not (over[0] == 400 and "serving cap" in over_msg
                and stream[0] == 404 and health[0] == 200
                and h.get("bundle") == str(aptai_bundle)
                and h.get("platforms") == [BUNDLE_DEVICE]
                and h.get("streaming") is False
                and one["flash_attn_fwd"] == layers
                and sum(one.values()) == layers):
            raise AssertionError("11d: the bundle app's cap, /v1/stream, "
                                 "/healthz or launches are wrong")
        return one
    finally:
        srv.shutdown()
        app.batcher.stop()
        live.batcher.stop()


def phase_export(root, aptai_ckpt, force_ckpt, card):
    log("== phase 11: the kernels as torch.library ops and the serving "
        "export")
    t_phase = time.perf_counter()
    phase_opcheck()
    op_host_cost(card)
    phase_small_bundles(root / "small_bundles")
    launches, aptai = phase_export_cli(root, aptai_ckpt, force_ckpt, card)
    launches["http_bundle"] = phase_bundle_http(*aptai, card)
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 12 -----------------------------------------------------------------

QUANT_MODES = ("w8a8_ffn", "w8a8")
# the encoder's GEMMs, (K, N): q/k/v/out, the FFN's first and second
QUANT_GEMMS = ((1024, 1024), (1024, 4096), (4096, 1024))
SERVING_ROWS = 32 * 499  # the encoder's rows at 32 x 10 s
# benchmarks/quant_ab.py's measures against the exact bf16 forward
QUANT_TV_REL_TOL = 0.05
QUANT_AGREE_MIN = 0.99


def int8_bound(m, k, n, nbytes):
    """(least ms for an int8 product of (M, K) by (K, N) moving ``nbytes``,
    what bounds it) at the card's dense int8 peak
    (``utils.flops.device_peak_int8_tops``); ``(None, "no int8 peak known
    for this card")`` where the table does not know the card."""
    peak = device_peak_int8_tops()
    if peak is None:
        return None, "no int8 peak known for this card"
    t_ops = 2 * m * k * n / (peak * 1e12)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_us(b) -> str:
    """An ``int8_bound`` in µs with what bounds it, or why it is absent."""
    return b[1] if b[0] is None else f"{b[0] * 1e3:.1f} µs, {b[1]}"


def same_bits(a, b) -> bool:
    """Equal bit for bit (bf16 or float32 by their integer views)."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def quant_gemm_case(gen, m, k, n, card):
    """12a at one shape: the int8 product exact, the card's quantize and
    W8A8 products (both dequantization orders) bit for bit the CPU's on
    the first 256 rows, and the times."""
    from aptai_tpu_torch.ops import quant
    import torch.nn.functional as F

    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5
    xq, wq = quant.quantize_rows(x), quant.quantize_weight(w)
    y = quant.int8_mm(xq.codes, wq.codes.t())
    exact = torch.equal(y, quant.int8_mm_plain(xq.codes, wq.codes.t()))
    r = min(m, 256)
    xc, wc = quant.quantize_rows(x[:r].cpu()), quant.quantize_weight(w.cpu())
    same = (torch.equal(xq.codes[:r].cpu(), xc.codes)
            and same_bits(xq.scale[:r], xc.scale)
            and torch.equal(wq.codes.cpu(), wc.codes)
            and same_bits(wq.scale, wc.scale))
    for fold in (False, True):
        same = same and same_bits(
            quant.w8a8_linear(xq, wq, fold, torch.bfloat16)[:r],
            quant.w8a8_linear(xc, wc, fold, torch.bfloat16))
    if not (exact and same):
        raise AssertionError(f"12a ({m}, {k}) x ({k}, {n}): int8 product "
                             f"exact {exact}, card = CPU {same}")
    wb = w.to(torch.bfloat16)
    w_kn = wq.codes.t().contiguous()  # the other layout: (K, N) row-major
    a = xq.codes if m > quant.INT_MM_MIN_ROWS else F.pad(
        xq.codes, (0, 0, 0, quant.INT_MM_MIN_ROWS + 1 - m))
    iters = 20 if m > 64 else 200
    t = {"linear_bf16": cuda_ms(lambda: F.linear(x, wb), iters),
         "int_mm": cuda_ms(lambda: torch._int_mm(a, wq.codes.t()), iters),
         "int_mm_kn": cuda_ms(lambda: torch._int_mm(a, w_kn), iters),
         "quantize_rows": cuda_ms(lambda: quant.quantize_rows(x), iters),
         "w8a8_op": cuda_ms(lambda: quant.w8a8_linear(
             quant.quantize_rows(x), wq, False, torch.bfloat16), iters)}
    b_bf16 = bound(2 * m * k * n, 2 * (m * k + k * n + m * n))
    b_int8 = int8_bound(m, k, n, m * k + k * n + 4 * m * n)
    # the whole op reads x (bf16) and the weight codes and scales, writes
    # the bf16 output
    b_op = int8_bound(m, k, n, 2 * m * k + k * n + 4 * n + 2 * m * n)
    log(f"  12a M {m}, K {k}, N {n}: int8 product exact, card = CPU bit "
        f"for bit (codes, scales, both orders, {r} rows); bf16 F.linear "
        f"{t['linear_bf16'] * 1e3:.1f} µs (bound {b_bf16[0] * 1e3:.1f}, "
        f"{b_bf16[1]}); _int_mm {t['int_mm'] * 1e3:.1f} µs with the (N, K)"
        f" codes transposed, {t['int_mm_kn'] * 1e3:.1f} µs with (K, N) "
        f"row-major (bound {bound_us(b_int8)}); "
        f"quantize_rows {t['quantize_rows'] * 1e3:.1f} µs; the whole W8A8 "
        f"op {t['w8a8_op'] * 1e3:.1f} µs (bound {bound_us(b_op)}) on "
        f"{card}")
    return {"m": m, "k": k, "n": n, **{f"{k_}_ms": v for k_, v in t.items()},
            "bound_bf16_ms": b_bf16[0], "bound_int8_ms": b_int8[0],
            "bound_op_ms": b_op[0]}


def phase_quant_gemms(card):
    """12a: each encoder GEMM shape at 32 x 10 s, and one padded row
    count."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(SERVING_ROWS, k, n) for k, n in QUANT_GEMMS] + [(5, 1024, 4096)]
    return [quant_gemm_case(gen, m, k, n, card) for m, k, n in cases]


def with_quantize_rows(fn, hook):
    """``fn()`` with every quantized layer's ``quantize_rows(x)`` replaced
    by ``hook(x, rows)`` (``rows`` the layer's own quantization)."""
    quantize_rows = w2v.quantize_rows
    w2v.quantize_rows = lambda x: hook(x, quantize_rows(x))
    try:
        return fn()
    finally:
        w2v.quantize_rows = quantize_rows


def check_small_quant_reference(device: str = "cuda"):
    """12b: a small float32 W8A8 APTAI (head dim 64) on the card against
    the same weights on the CPU. Dynamic quantization is discontinuous: a
    value at a rounding tie gets codes one step apart on the two devices
    when their float32 activations differ in the last bits, and each such
    flip moves the later activations by far more than float32 rounding,
    which flips more codes. So the CPU runs twice: with each quantized
    layer given the card's codes and scales for its input (every other op
    its own), under phase 3's small-model gates, its own codes differing
    from the card's by one step at most; and free, its codes that differ
    from the card's counted and its outputs held to 12c's deviation gates
    against the card's."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256, quant="w8a8")
    model = random_aptai(cfg, seed=1, num_phonemes=46)
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_000, 31_000, 9_000)]
    card_rows = []

    def record(x, rows):
        card_rows.append(quant.QuantizedRows(rows.codes.cpu(),
                                             rows.scale.cpu()))
        return rows

    gpu = with_quantize_rows(lambda: APTAIPredictor(
        model, device=device).predict_batch(wavs), record)
    gpu = {k: v.cpu() for k, v in gpu.items()}
    cpu_pred = APTAIPredictor(model, device="cpu")
    counts = {"forced": [], "free": []}

    def compare(run):
        def hook(x, rows):
            want = card_rows[len(counts[run])]
            diff = (rows.codes.int() - want.codes.int()).abs()
            counts[run].append((int((diff != 0).sum()), int(diff.max())))
            return want if run == "forced" else rows
        return hook

    out = {run: with_quantize_rows(
        lambda: {k: v.clone() for k, v in cpu_pred.predict_batch(
            wavs).items()}, compare(run)) for run in counts}
    forced, free = out["forced"], out["free"]
    err_tv = float((gpu["tvs_pred"] - forced["tvs_pred"]).abs().max())
    err_p = float((gpu["phn_fc_probs"] - forced["phn_fc_probs"]).abs().max())
    rel, agree = quant_deviation(free, gpu)
    total = sum(r.codes.numel() for r in card_rows)
    log(f"  12b small f32 W8A8 model, card vs CPU given the card's codes: "
        f"tvs max_abs_err {err_tv:.2e}, probs max_abs_err {err_p:.2e}; the "
        f"CPU's own codes differ from the card's in {[c for c, _ in counts['forced']]}"
        f" of {total} (by one step at most: "
        f"{max(m for _, m in counts['forced'])}); free, the codes that "
        f"differ by quantization {[c for c, _ in counts['free']]}, TV RMS "
        f"relative error {rel:.5f}, frame-phoneme agreement {agree:.4%}")
    n = 4 * cfg.num_hidden_layers
    if not (len(card_rows) == len(counts["forced"]) == len(counts["free"])
            == n and np.array_equal(gpu["frame_lengths"],
                                    forced["frame_lengths"])
            and err_tv <= 1e-3 and err_p <= 1e-4
            and max(m for _, m in counts["forced"]) <= 1
            and rel <= QUANT_TV_REL_TOL and agree >= QUANT_AGREE_MIN):
        raise AssertionError("12b: the card disagrees with the CPU reference")


def quant_deviation(got, want):
    """``benchmarks/quant_ab.py``'s measures: the TVs' RMS error relative
    to the exact forward's, and the frame phonemes' agreement."""
    tv_g, tv_w = got["tvs_pred"].float(), want["tvs_pred"].float()
    rel = float(torch.linalg.vector_norm(tv_g - tv_w)
                / torch.linalg.vector_norm(tv_w))
    return rel, float((got["phn_fc_pred"] == want["phn_fc_pred"])
                      .float().mean())


QUANT_BUILD_DEVICE = "cuda"


def quant_copy(model, cls, mode):
    """``model``'s weights in a new ``cls`` under ``quant=mode``, built on
    the card, where its own init (overwritten) is quick."""
    cfg = model.cfg
    with torch.device(QUANT_BUILD_DEVICE):
        out = cls(dataclasses.replace(cfg, quant=mode))
    out.load_state_dict(model.state_dict())
    return out


def one_batch(fn):
    """The launch counts and the peak memory (GiB) of one ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), torch.cuda.max_memory_allocated() / 2**30


def phase_quant_serving(card):
    """12c: full-width APTAI at 32 x 10 s in each mode (the same weights),
    alternated none, w8a8_ffn, w8a8, w8a8, w8a8_ffn, none; the deviation
    gates against the exact forward; W2V2PR with the fused feature
    extractor and FORCE greedy, one w8a8 batch each; launches and peak
    memory of one batch in each; a profile of one w8a8_ffn batch."""
    cfg = Wav2Vec2Config(dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    exact = random_aptai(cfg, seed=0)
    preds = {"none": APTAIPredictor(exact)}
    for mode in QUANT_MODES:
        preds[mode] = APTAIPredictor(quant_copy(exact, APTAI, mode))
    del exact
    log(f"  full-width APTAI (bf16, seed 0) in three modes on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    outs, launches, peaks = {}, {}, {}
    for mode, pred in preds.items():
        pred.predict_batch(wavs)  # weight codes made and cached
        outs[mode], launches[mode], peaks[mode] = one_batch(
            lambda: pred.predict_batch(wavs, fields=("tvs_pred",
                                                     "phn_fc_pred")))
        if launches[mode] != {**{k: 0 for k in COUNTED},
                              "flash_attn_fwd": layers}:
            raise AssertionError(f"12c: an APTAI {mode} batch launched "
                                 f"{launches[mode]}")
    legs = []
    for mode in ("none", "w8a8_ffn", "w8a8", "w8a8", "w8a8_ffn", "none"):
        sec = float(np.median(timed_batches(
            lambda: preds[mode].predict_batch(wavs))))
        legs.append((mode, 32 * 10 / sec))
        log(f"  {mode}: {32 * 10 / sec:.1f} audio-s/s, {sec * 1e3:.2f} ms "
            f"per batch")
    speed = {m: float(np.mean([v for n, v in legs if n == m])) for m in preds}
    dev = {m: quant_deviation(outs[m], outs["none"]) for m in QUANT_MODES}
    for mode in preds:
        rel, agree = dev.get(mode, (0.0, 1.0))
        log(f"  12c APTAI {mode}: mean {speed[mode]:.1f} audio-s/s "
            f"({speed[mode] / speed['none']:.3f}x exact), TV RMS relative "
            f"error {rel:.5f}, frame-phoneme agreement {agree:.4%} against "
            f"exact bf16, launches a batch {launches[mode]}, peak memory "
            f"{peaks[mode]:.2f} GiB on {card}")
        if rel > QUANT_TV_REL_TOL or agree < QUANT_AGREE_MIN:
            raise AssertionError(f"12c: APTAI {mode} deviates from the "
                                 f"exact forward beyond the gates")
    profile_breakdown(lambda: preds["w8a8_ffn"].predict_batch(wavs),
                      "one w8a8_ffn APTAI batch at 32 x 10 s", top=20)
    del preds, outs
    torch.cuda.empty_cache()

    pr_cfg = dataclasses.replace(cfg, fused_feature_extractor=True)
    exact = random_w2v2_pr(pr_cfg, seed=0)
    pr = {"none": W2V2PRPredictor(exact),
          "w8a8": W2V2PRPredictor(quant_copy(exact, W2V2PR, "w8a8"))}
    del exact
    out = {}
    for mode, pred in pr.items():
        pred.encode_batch(wavs)
        out[mode], counts, peak = one_batch(
            lambda: pred.encode_batch(wavs, fields=("phoneme_logits",)))
    logits = {m: o["phoneme_logits"].float() for m, o in out.items()}
    rel = float(torch.linalg.vector_norm(logits["w8a8"] - logits["none"])
                / torch.linalg.vector_norm(logits["none"]))
    agree = float((logits["w8a8"].argmax(-1) == logits["none"].argmax(-1))
                  .float().mean())
    log(f"  12c W2V2PR fused FE, w8a8: logits RMS relative error {rel:.5f},"
        f" frame argmax agreement {agree:.4%} against exact bf16; launches "
        f"{counts}, peak memory {peak:.2f} GiB")
    want = {**{k: 0 for k in COUNTED}, "flash_attn_fwd": layers,
            "fused_conv_ln_gelu": 6}
    if counts != want or not torch.isfinite(logits["w8a8"]).all():
        raise AssertionError(f"12c: a W2V2PR w8a8 batch launched {counts}"
                             f" (want {want}) or gave non-finite logits")
    w2v2_pr_counts = counts
    del pr, out, logits
    torch.cuda.empty_cache()

    exact = random_force_aptai(cfg, seed=0)
    force = {"none": ForceAPTAIPredictor(exact),
             "w8a8": ForceAPTAIPredictor(quant_copy(exact, ForceAPTAI,
                                                    "w8a8"))}
    del exact
    fields = ("tvs_pred", "pred_ctc_phn_seq", "phn_seq_lengths")
    out = {}
    for mode, pred in force.items():
        pred.predict_batch(wavs)
        out[mode], counts, peak = one_batch(
            lambda: pred.predict_batch(wavs, fields=fields))
    host = {m: fetch_outputs(o) for m, o in out.items()}
    tv_w = host["none"]["tvs_pred"].astype(np.float64)
    rel = float(np.linalg.norm(host["w8a8"]["tvs_pred"] - tv_w)
                / np.linalg.norm(tv_w))
    seqs = {m: [tuple(h["pred_ctc_phn_seq"][i, :h["phn_seq_lengths"][i]])
                for i in range(len(wavs))] for m, h in host.items()}
    same = sum(a == b for a, b in zip(seqs["w8a8"], seqs["none"]))
    log(f"  12c FORCE greedy, w8a8: TV RMS relative error {rel:.5f} against "
        f"exact bf16, decoded sequences identical {same}/{len(wavs)}; "
        f"launches {counts}, peak memory {peak:.2f} GiB")
    want = {**{k: 0 for k in COUNTED}, "flash_attn_fwd": layers}
    if counts != want or rel > QUANT_TV_REL_TOL:
        raise AssertionError(f"12c: a FORCE w8a8 batch launched {counts} "
                             f"or its TVs deviate beyond the gate")
    del force, out
    torch.cuda.empty_cache()
    return ({m: (launches[m], speed[m], dev.get(m), peaks[m]) for m in
             ("none",) + QUANT_MODES}, w2v2_pr_counts, counts)


def phase_quant_http(aptai_ckpt, card):
    """12d: ``build_app(quant="w8a8_ffn")`` over phase 8's APTAI run behind
    the native transport: 8 ``/v1/predict`` requests against
    ``ServingApp.handle`` over ``load_predictor(quant="w8a8_ffn")`` (the
    same batches: byte for byte, and phase 9b's gates). Returns the
    launches of one request alone."""
    from aptai_tpu_torch.infer.serve import KIND_FIELDS, ServingApp

    t0 = time.perf_counter()
    app = build_app(str(aptai_ckpt), quant="w8a8_ffn")
    build_s = time.perf_counter() - t0
    model = app.batcher.predict_batch.__self__.model
    direct = ServingApp(MicroBatcher(
        load_predictor(aptai_ckpt, quant="w8a8_ffn").predict_batch,
        max_batch_size=16, fields=KIND_FIELDS["aptai"]).start(), "aptai",
        vocab=app.vocab)
    layers = Wav2Vec2Config().num_hidden_layers
    srv = make_native_server(app, "127.0.0.1", 0)
    try:
        reqs = [(w.tobytes(), {"Content-Type": "application/octet-stream"})
                for w in export_requests(19, 8)]
        reset_counts()
        results = [request_once(srv.port, "POST", "/v1/predict",
                                *reqs[0])[::2]]
        one = read_counts()
        results += [request_once(srv.port, "POST", "/v1/predict", *r)[::2]
                    for r in reqs[1:]]
        want = [direct.handle("POST", "/v1/predict", r[1], r[0])
                for r in reqs]
        r, a, single = check_http_answers(results, want, "w8a8_ffn")
        same = sum(g[1] == w[1] for g, w in zip(results, want))
        health = request_once(srv.port, "GET", "/healthz", None, {})
        log(f"  12d build_app(quant='w8a8_ffn') over phase 8's APTAI run "
            f"(warm-up included) in {build_s:.1f} s, native transport: 8 "
            f"/v1/predict requests against the quantized predictor's "
            f"ServingApp.handle: {same}/8 byte for byte, per-TV Pearson min "
            f"{r:.6f} (one response's min {single:.6f}), frame agreement "
            f"{a:.4%}; one request alone launched {one}; /healthz "
            f"{health[0]} on {card}")
        if not (model.cfg.quant == "w8a8_ffn"
                and app.streamer.model is model and health[0] == 200
                and one["flash_attn_fwd"] == layers
                and sum(one.values()) == layers):
            raise AssertionError("12d: the quantized app's model, streamer, "
                                 "/healthz or launches are wrong")
        return one
    finally:
        srv.shutdown()
        app.batcher.stop()
        direct.batcher.stop()


def phase_quant(aptai_ckpt, card):
    log("== phase 12: W8A8 int8 serving")
    t_phase = time.perf_counter()
    phase_quant_gemms(card)
    check_small_quant_reference()
    aptai, w2v2_pr, force = phase_quant_serving(card)
    launches = {f"serving_{m}": aptai[m][0] for m in QUANT_MODES}
    launches["w2v2_pr_serving_w8a8_fused_fe"] = w2v2_pr
    launches["force_serving_w8a8"] = force
    launches["http_serving_w8a8_ffn"] = phase_quant_http(aptai_ckpt, card)
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 13 -----------------------------------------------------------------

# the encoder's three config variants, alone and together
ENCODER_VARIANTS = {
    "fused_qkv": dict(fused_qkv=True),
    "bthd": dict(attention_layout="bthd"),
    "non_stable": dict(do_stable_layer_norm=False),
    "all_three": dict(fused_qkv=True, attention_layout="bthd",
                      do_stable_layer_norm=False),
}
# where 13b-13d build and run their models ("cpu" rehearses them)
VARIANT_DEVICE = "cuda"


def split_qkv(gen, b, t, h):
    """bf16 q, k and v as ``fused_qkv`` hands them to the kernels: (B, H,
    T, 64) views of one (B, T, 3C) tensor, whose time stride is 3C."""
    c = h * 64
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(
        torch.bfloat16)
    return [x.view(b, t, h, 64).transpose(1, 2) for x in qkv.split(c, -1)]


def check_split_views(gen, name, b, t, lengths, card):
    """13a: the flash forward, dq and dk/dv on split qkv views against
    their plain versions under phase 2's gates, and bit for bit against
    the same kernels on contiguous copies (the same arithmetic, other
    addresses); the forward's time on the views and on the copies.
    Returns the max abs errors {kernel: err}."""
    h = 16
    q, k, v = split_qkv(gen, b, t, h)
    dout = _qkv(gen, b, h, t, torch.bfloat16, True, n=1)[0]
    if q.stride(2) != 3 * h * 64 or q.is_contiguous():
        raise AssertionError(f"13a: not a split view: {q.stride()}")
    errs = check_kernel_case(name, q, k, v, dout, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def run(q, k, v):
        out, lse = attention.flash_attention_bhtd_cuda(q, k, v, lens,
                                                       return_lse=True)
        dq, delta = attention.flash_attention_bwd_dq_cuda(q, k, v, out, lse,
                                                          dout, lens)
        dk, dv = attention.flash_attention_bwd_dkv_cuda(q, k, v, dout, lse,
                                                        delta, lens)
        return out, lse, dq, delta, dk, dv

    copies = [x.contiguous() for x in (q, k, v)]
    same = all(torch.equal(a, c) for a, c in zip(run(q, k, v), run(*copies)))
    fwd = {what: cuda_ms(lambda: attention.flash_attention_bhtd_cuda(
        *xs, lens), 20) for what, xs in (("views", (q, k, v)),
                                         ("copies", copies))}
    log(f"  {name}: views bit for bit the contiguous copies' outputs, "
        f"logsumexp, dq, delta, dk and dv: {same}; forward "
        f"{fwd['views'] * 1e3:.1f} us on the views, "
        f"{fwd['copies'] * 1e3:.1f} us on the copies, on {card}")
    if not same:
        raise AssertionError(f"13a: the kernels read split views unlike "
                             f"contiguous copies ({name})")
    return errs


def variant_model(base_sd, cfg, **kw):
    """Full-width APTAI in the variant ``kw`` holding the weights of
    ``base_sd`` (the default model's; q, k and v concatenated for
    ``fused_qkv``), built on :data:`VARIANT_DEVICE`."""
    cfg = dataclasses.replace(cfg, **kw)
    with torch.device(VARIANT_DEVICE):
        model = APTAI(cfg)
    model.load_state_dict(fuse_qkv_state_dict(base_sd) if cfg.fused_qkv
                          else base_sd, strict=True)
    return model


def served_batch(pred, wavs, layers, what):
    """One ``predict_batch`` after a warm-up: its outputs on the host,
    launches (``layers`` forward launches and nothing else), the encoder
    output's dtype, peak memory; then audio-s/s over 5 timed batches."""
    pred.predict_batch(wavs)
    dtypes = []
    hook = pred.model.wav2vec2.register_forward_hook(
        lambda m, args, out: dtypes.append(out[0].dtype))
    try:
        out, counts, peak = one_batch(lambda: pred.predict_batch(
            wavs, fields=("tvs_pred", "phn_fc_probs", "phn_fc_pred")))
    finally:
        hook.remove()
    if counts != {**{k: 0 for k in COUNTED}, "flash_attn_fwd": layers}:
        raise AssertionError(f"13: a {what} batch launched {counts}")
    out = {k: v.cpu() for k, v in out.items()}
    if not all(torch.isfinite(out[k].float()).all()
               for k in ("tvs_pred", "phn_fc_probs")):
        raise AssertionError(f"13: a {what} batch gave non-finite outputs")
    sec = float(np.median(timed_batches(lambda: pred.predict_batch(wavs))))
    audio_s = sum(len(w) for w in wavs) / SAMPLE_RATE
    return out, counts, dtypes[0], peak, audio_s / sec


def phase_variant_serving(cfg, base_sd, wavs, card):
    """13b: full-width APTAI at 32 x 10 s in the default and each variant
    (the default's weights): "bthd" equal to the default bit for bit,
    ``fused_qkv`` within phase 3's serving gates of it (its one
    (C, 3C) GEMM may take another cuBLAS kernel than three (C, C) ones),
    the non-stable encoder's output float32 and "all_three" within the
    same gates of "non_stable"."""
    layers = cfg.num_hidden_layers
    outs, launches = {}, {}
    for name in ("default",) + tuple(ENCODER_VARIANTS):
        pred = APTAIPredictor(variant_model(
            base_sd, cfg, **ENCODER_VARIANTS.get(name, {})),
            device=VARIANT_DEVICE)
        outs[name], launches[name], dtype, peak, speed = served_batch(
            pred, wavs, layers, name)
        del pred
        torch.cuda.empty_cache()
        log(f"  13b {name}: {speed:.1f} audio-s/s, launches a batch "
            f"{launches[name]}, encoder output {dtype}, peak memory "
            f"{peak:.2f} GiB on {card}")
        want = (torch.float32 if name in ("non_stable", "all_three")
                else torch.bfloat16)
        if dtype != want:
            raise AssertionError(f"13b: the {name} encoder gave {dtype}")
    same = all(torch.equal(outs["bthd"][k], outs["default"][k])
               for k in outs["default"])
    log(f"  13b bthd bit for bit the default: {same}")
    if not same:
        raise AssertionError("13b: bthd differs from the default")
    def frames(out):  # every frame of the batch, as one recording's
        return {"tvs_pred": out["tvs_pred"].float().reshape(-1, 9).numpy(),
                "phn_fc_pred": out["phn_fc_pred"].reshape(-1).numpy()}

    for name, ref in (("fused_qkv", "default"), ("all_three", "non_stable")):
        r, agree = served_agreement(frames(outs[name]), frames(outs[ref]))
        equal = all(torch.equal(outs[name][k], outs[ref][k])
                    for k in outs[ref])
        err = float((outs[name]["tvs_pred"].float()
                     - outs[ref]["tvs_pred"].float()).abs().max())
        log(f"  13b {name} vs {ref}: per-TV Pearson min {r:.6f}, "
            f"frame-phoneme agreement {agree:.4%}, TV max_abs_err "
            f"{err:.3e}, bit for bit {equal}")
        if r < 0.999 or agree < 0.99:
            raise AssertionError(f"13b: {name} disagrees with {ref}")
    return outs["default"], {f"serving_{n}": launches[n]
                             for n in ENCODER_VARIANTS}


def phase_variant_train(cfg, base_sd, card):
    """13c: one APTAI train step at 8 x 5 s in ``fused_qkv`` + non-stable
    (bf16 compute, float32 masters, dropout and SpecAugment on): a finite
    loss, 24 launches of each flash kernel; step ms; then the gradients of
    every encoder tensor (``qkv_proj``'s among them) through the kernels
    against plain attention under phase 5's gates."""
    layers = cfg.num_hidden_layers
    model = variant_model(base_sd, cfg, fused_qkv=True,
                          do_stable_layer_norm=False)
    batch = train_batch(cfg)
    b, samples = batch["audio"].shape
    step = TrainStep(model, torch_adam(model), device=VARIANT_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    _, counts = checked_first_step(step, batch, layers)
    times, m = timed_steps(step, batch, 3)
    sec = float(np.median(times))
    log(f"  13c fused_qkv + non-stable step: times (s) "
        f"{[round(x, 5) for x in times]}, {sec * 1e3:.2f} ms a step, "
        f"{b * samples / SAMPLE_RATE / sec:.1f} train audio-s/s, last loss "
        f"{m['loss'].item():.5f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    model.eval()
    grads = grads_kernels_vs_plain(model, [
        torch.as_tensor(batch[k]).to(VARIANT_DEVICE) for k in (
            "audio", "audio_lengths", "phn_frames", "tv_targets")], layers,
        "13c fused_qkv + non-stable encoder gradients, kernels vs plain")
    if not all(f"wav2vec2.encoder.layers.{i}.attention.qkv_proj.weight"
               in grads for i in range(layers)):
        raise AssertionError("13c: qkv_proj got no gradient")
    del step, model, grads
    torch.cuda.empty_cache()
    return counts


def phase_variant_quant(cfg, base_sd, wavs, exact, card):
    """13d: one ``quant="w8a8"`` batch in "bthd" and one in ``fused_qkv``:
    the FFN's two Linears a layer are the quantized ones, as in the JAX
    package; 12c's deviation gates against the exact default."""
    layers = cfg.num_hidden_layers
    launches = {}
    for layout in ("bthd", "fused_qkv"):
        model = variant_model(base_sd, cfg, quant="w8a8",
                              **ENCODER_VARIANTS[layout])
        quantized = [n for n, mod in model.named_modules()
                     if isinstance(mod, w2v.QuantLinear)]
        if (len(quantized) != 2 * layers
                or not all(".feed_forward." in n for n in quantized)):
            raise AssertionError(f"13d: {layout} w8a8 quantizes {quantized}")
        pred = APTAIPredictor(model, device=VARIANT_DEVICE)
        out, counts, _, peak, speed = served_batch(pred, wavs, layers,
                                                   f"{layout} w8a8")
        del pred, model
        torch.cuda.empty_cache()
        rel, agree = quant_deviation(out, exact)
        log(f"  13d {layout} w8a8: {len(quantized)} quantized Linears (the "
            f"FFN's), {speed:.1f} audio-s/s, TV RMS relative error "
            f"{rel:.5f}, frame-phoneme agreement {agree:.4%} against exact "
            f"bf16, launches {counts}, peak memory {peak:.2f} GiB on {card}")
        if rel > QUANT_TV_REL_TOL or agree < QUANT_AGREE_MIN:
            raise AssertionError(f"13d: {layout} w8a8 deviates beyond 12c's "
                                 f"gates")
        launches[f"serving_w8a8_{layout}"] = counts
    return launches


def phase_variants(card):
    log("== phase 13: the encoder's config variants")
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rng = np.random.default_rng(13)
    check_split_views(gen, "13a split qkv views, serving shape", 32, 499,
                      [0, 1, 499] + rng.integers(2, 500, 29).tolist(), card)
    check_split_views(gen, "13a split qkv views, training shape", 8, 249,
                      [0, 1, 249] + rng.integers(2, 250, 5).tolist(), card)
    check_small_reference(VARIANT_DEVICE,
                          "13b small f32 APTAI in all three variants",
                          **ENCODER_VARIANTS["all_three"])
    cfg = Wav2Vec2Config(dtype="bfloat16")
    t0 = time.perf_counter()
    base_sd = random_aptai(cfg, seed=0).state_dict()
    log(f"  the default full-width APTAI's weights (bf16, seed 0) drawn on "
        f"the host in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal(10 * SAMPLE_RATE) * 0.1).astype(np.float32)
            for _ in range(32)]
    exact, launches = phase_variant_serving(cfg, base_sd, wavs, card)
    step = phase_variant_train(cfg, base_sd, card)
    launches.update(phase_variant_quant(cfg, base_sd, wavs, exact, card))
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, step


# -- phase 14 -----------------------------------------------------------------

# the prep's --platform for the card's tree ("cpu" rehearses phase 14 on the
# CPU, with PREP_TINY a small backbone for its epoch)
PREP_PLATFORM = "auto"
PREP_TINY = None
# the card's log-mel and MFCC against the CPU's, relative to the CPU
# value's largest magnitude: float32 FFT and matmul sums in other orders
# behind a log (the CPU tests' tolerance for these ops)
PREP_SPECTRAL_RTOL = 1e-4


def run_prep_cli(raw, prep, platform):
    """``python -m aptai_tpu_torch.data.hprc_prep <raw> --prep <prep>
    --platform <platform>`` as a child process; returns its seconds: the
    whole run, the interpreter's start up to step 1, each step (from its
    line to the next one's) and ``prepare_hprc`` as the child timed it."""
    cmd = [sys.executable, "-u", "-m", "aptai_tpu_torch.data.hprc_prep",
           str(raw), "--prep", str(prep), "--platform", platform]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=_package_env())
    marks, lines = [], []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if line.startswith("[") and "/8]" in line[:6]:
            marks.append((line[1], time.perf_counter()))
    rc = proc.wait()
    end = time.perf_counter()
    if rc != 0 or len(marks) != 8:
        raise AssertionError(f"14: the prep CLI on {platform} exited {rc}:\n"
                             + "\n".join(lines[-20:]))
    steps = {k: b - a for (k, a), (_, b) in zip(marks, marks[1:] +
                                                 [("end", end)])}
    inner = float(lines[-1].split(" in ")[-1].split()[0])
    return {"wall": end - t0, "start": marks[0][1] - t0, "steps": steps,
            "prepare": inner}


def compare_prep_trees(card_tree, cpu_tree):
    """The card's tree against the CPU's: the log-mel and MFCC pickles
    within ``PREP_SPECTRAL_RTOL``, every other file (wavs, texts, EMA,
    TV and F0 pickles, ``vocab.json``) byte for byte, and the manifests
    with the roots swapped. Returns the files compared and the largest
    spectral error."""
    files = sorted(p.relative_to(card_tree) for p in card_tree.rglob("*")
                   if p.is_file())
    if files != sorted(p.relative_to(cpu_tree) for p in cpu_tree.rglob("*")
                       if p.is_file()):
        raise AssertionError("14: the card's and the CPU's trees hold "
                             "other files")
    worst, bad = 0.0, []
    for rel in files:
        a, b = card_tree / rel, cpu_tree / rel
        if rel.parent.name in ("mspec", "mfccs"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                got, want = pickle.load(fa), pickle.load(fb)
            if not (type(got) is np.ndarray and got.dtype == np.float32
                    and got.shape == want.shape):
                bad.append(str(rel))
                continue
            err = float(np.abs(got - want).max() / np.abs(want).max())
            worst = max(worst, err)
            if not err <= PREP_SPECTRAL_RTOL:
                bad.append(str(rel))
        elif rel.name == "hprc.csv":
            if (a.read_bytes().replace(str(card_tree).encode(), b"")
                    != b.read_bytes().replace(str(cpu_tree).encode(), b"")):
                bad.append(str(rel))
        elif a.read_bytes() != b.read_bytes():
            bad.append(str(rel))
    if bad:
        raise AssertionError(f"14: the card's tree differs from the CPU's in "
                             f"{bad[:8]} ({len(bad)} files)")
    return len(files), worst


def phase_hprc_prep(card, root):
    """Phase 14 in the directory ``root``: a raw HPRC tree through the prep
    CLI on the card and through ``prepare_hprc`` on the CPU, the two trees
    compared, then one APTAI epoch at full width from the card's manifest.
    Returns the epoch's launches and steps."""
    log("== phase 14: from a raw HPRC tree to an APTAI run")
    t_phase = time.perf_counter()
    raw, prep, cpu_prep = root / "raw", root / "prep", root / "prep_cpu"
    t0 = time.perf_counter()
    keys = make_synthetic_hprc_raw(raw, texts=2, seconds=(2.0, 4.0),
                                   fs=44_100, seed=14, phonemes_root=prep)
    shutil.copytree(prep, cpu_prep)
    n_utts = sum(len(k) for k in keys.values())
    mats = len(list(raw.glob("*/data/*.mat")))
    log(f"  14a raw tree: {len(keys)} speakers, {mats} .mat files "
        f"({n_utts} utterances of 2-4 s at 44.1 kHz, R01 and R02, N and F; "
        f"F02 without ML; one palate a speaker), {dir_gb(raw):.3f} GB, "
        f"written in {time.perf_counter() - t0:.1f} s with the MAUS "
        f"TextGrids in place of the alignment")
    t = run_prep_cli(raw, prep, PREP_PLATFORM)
    steps = ", ".join(f"[{k}/8] {v:.2f} s" for k, v in t["steps"].items())
    log(f"  14b prep CLI --platform {PREP_PLATFORM}: {t['wall']:.2f} s wall "
        f"(interpreter start {t['start']:.2f} s; {steps}); prepare_hprc "
        f"{t['prepare']:.2f} s = {n_utts / t['prepare']:.1f} utterances/s "
        f"({n_utts / t['wall']:.1f} with the start) on {card}")
    t0 = time.perf_counter()
    prepare_hprc(raw, cpu_prep, log=lambda *_: None, device="cpu")
    cpu_s = time.perf_counter() - t0
    log(f"  14b the same tree prepared on the host CPU in this process: "
        f"{cpu_s:.2f} s = {n_utts / cpu_s:.1f} utterances/s")
    n_files, worst = compare_prep_trees(prep, cpu_prep)
    hprc_csv = prep / "hprc.csv"
    rows = read_rows(hprc_csv)
    log(f"  14c the card's tree against the CPU's: {n_files} files, log-mel "
        f"and MFCC within {worst:.2e} relative (gate "
        f"{PREP_SPECTRAL_RTOL:g}), the rest byte for byte; manifest "
        f"{len(rows)} R01 rows of {n_utts} utterances")
    if not (len(rows) == n_utts // 2 and all(
            "R01" in r["path_wav"] and r["phn_frames_49hz"] for r in rows)):
        raise AssertionError("14c: the manifest's rows")

    spk = rows[-1]["speaker"]
    cfg = APTAIConfig(exp_dir=str(root / "aptai"), hprc_csv_path=str(hprc_csv),
                      vocab_path=str(prep / "vocab.json"), batch_size=4,
                      num_epochs=1, platform=PREP_PLATFORM).finalize("APTAI")
    t0 = time.perf_counter()
    with FitProbe(train_aptai) as probe:
        _, _, per = train_aptai.run(cfg, tiny_backbone=PREP_TINY,
                                    speakers=[spk])
    rec = probe.calls[0]
    epoch, steps = rec["epochs"][0], len(rec["batches"])
    layers = rec["model"].cfg.num_hidden_layers
    hist = rec["history"]
    log(f"  14d train_aptai.run, fold {spk}, 1 epoch from the prepared "
        f"manifest: {time.perf_counter() - t0:.1f} s, {steps} steps, "
        f"{hist[0]['train_seconds'] / max(steps, 1) * 1e3:.2f} ms a step, "
        f"launches {epoch} ({per_step(epoch, steps)} a step), "
        f"test_N_mean_rmse {per[0].get('test_N_mean_rmse', float('nan')):.4f}"
        f" on {card}")
    finite = all(np.isfinite(v) for v in per[0].values())
    if not (steps > 0 and finite and (PREP_PLATFORM == "cpu" or (
            epoch["fused_conv_ln_gelu"] == 0
            and all(epoch[k] == layers * steps for k in FLASH)))):
        raise AssertionError(f"14d: the epoch's launches {epoch} over "
                             f"{steps} steps, finite {finite}")
    del rec, probe
    torch.cuda.empty_cache()
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return epoch, steps



CKPT_STEPS = 3  # full-width train steps before the write


def fsync_seconds(paths) -> float:
    """The seconds to flush ``paths`` to the disk (the write left them in
    the page cache)."""
    t0 = time.perf_counter()
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return time.perf_counter() - t0


def gb_rate(nbytes, seconds) -> str:
    return f"{nbytes / 1e9:.3f} GB in {seconds:.3f} s = " \
           f"{nbytes / 1e9 / seconds:.2f} GB/s"


def same_tensors(got, want) -> bool:
    return got.keys() == want.keys() and all(
        torch.equal(v, want[k]) for k, v in got.items())


def update_gap(got, want, before):
    """How far the update ``got - before`` is from ``want - before``:
    relative L2 over all tensors (float64), and the names of the tensors
    that differ."""
    num = den = 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double()).norm().item()
        num += d * d
        den += (w.double() - before[k].double()).norm().item() ** 2
    names = [k for k in want if not torch.equal(got[k], want[k])]
    return (num / max(den, 1e-300)) ** 0.5, names


def phase_checkpoint(card, root):
    """Phase 15 in the directory ``root``: full-width APTAI (bf16 compute,
    float32 masters, seed 0) takes ``CKPT_STEPS`` steps at 8 x 5 s; the
    manager writes best and last in the JAX package's files (timed: the
    bridge's layouts on the card, the device→host copy, the msgpack
    headers, the file writes; then the flush to disk), beside
    ``torch.save`` of the same state as this package's older ``.pt``
    files; both files read back equal the live parameters and Adam moments
    bit for bit (float32 leaves, an int32 count); then ``fit`` resumes a
    model of other weights from them for one step, which must equal the
    live model's next step. Returns the phase's launches and steps."""
    log("== phase 15: the JAX package's checkpoint files at full width")
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    # the pos conv's weight gradient may take a cuDNN algorithm that adds
    # in any order; the resumed step is held to the live one bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_checkpoint(card, root, t_phase)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _phase_checkpoint(card, root, t_phase):
    backbone = Wav2Vec2Config(dtype="bfloat16")
    cfg = APTAIConfig(exp_dir=str(root / "run"), num_epochs=2,
                      platform=PLATFORM, train_from_ckpt=True)
    model_cfg = {"backbone": dataclasses.asdict(backbone), "kind": "aptai",
                 "vocab": {f"p{i}": i for i in range(46)}}
    batch = train_batch(backbone)
    model = random_aptai(backbone, seed=0)
    step = make_engine(cfg, aptai_loss_fn(), model)
    reset_counts()
    for _ in range(CKPT_STEPS):
        step(batch, 1e-5)
    torch.cuda.synchronize()

    ckpt = CheckpointManager(root / "run", "m")
    t0 = time.perf_counter()
    ckpt.update(0, {"m": 1.0}, model.state_dict(),
                opt_state=JaxAdamState.from_optimizer(step.optimizer, model),
                step=step.step_count, model_cfg=model_cfg)
    write_s = time.perf_counter() - t0
    w = ckpt.write_seconds
    files = sorted((root / "run").rglob("*.msgpack"))
    flush_s = fsync_seconds(files)
    log(f"  15a {CKPT_STEPS} steps, then CheckpointManager.update (best "
        f"params, last params + Adam state as params.msgpack / "
        f"opt_state.msgpack): {gb_rate(w['bytes'], write_s)}; bridge "
        f"layouts on the card {w['bridge_s']:.3f} s, device->host "
        f"{w['host_s']:.3f} s, msgpack headers {w['encode_s']:.3f} s, file "
        f"writes {w['disk_s']:.3f} s (page cache); fsync after "
        f"{flush_s:.3f} s on {card}")

    old = root / "torch_save"
    t0 = time.perf_counter()
    params = to_host(model.state_dict())
    host_s = time.perf_counter() - t0
    save_state(old / "best" / "params.pt", params)
    save_state(old / "last" / "params.pt", params)
    save_state(old / "last" / "opt_state.pt", step.optimizer.state_dict())
    save_s = time.perf_counter() - t0
    old_files = sorted(old.rglob("*.pt"))
    old_bytes = sum(f.stat().st_size for f in old_files)
    old_flush = fsync_seconds(old_files)
    log(f"  15a torch.save of the same state as the older .pt files (params "
        f"to the host once, best and last params.pt, opt_state.pt): "
        f"{gb_rate(old_bytes, save_s)} (device->host of the params "
        f"{host_s:.3f} s); fsync after {old_flush:.3f} s")
    shutil.rmtree(old)

    live = host_state(step)
    raw = mapped_flax(ckpt.best_dir / "params.msgpack")
    adam_raw = mapped_flax(ckpt.last_dir / "opt_state.msgpack")["0"]
    dtypes = {str(a.dtype) for a in (
        list(leaves(raw)) + list(leaves(adam_raw["mu"]))
        + list(leaves(adam_raw["nu"])))}
    t0 = time.perf_counter()
    last_params, adam_back, meta = CheckpointManager(
        root / "run", "m").restore_last()
    read_s = time.perf_counter() - t0
    best_same = same_tensors(read_params(ckpt.best_dir), live["params"])
    last_same = same_tensors(last_params, live["params"])
    adam_same = same_adam(adam_back, live["adam"])
    fe_zero = [k for k in adam_back.exp_avg if k not in live["adam"].exp_avg]
    log(f"  15b restore_last (this package's msgpack reader and bridge, "
        f"params and Adam state to CPU tensors) in {read_s:.2f} s: leaves "
        f"{sorted(dtypes)}, count "
        f"{adam_raw['count'].dtype} {int(adam_raw['count'])}; best params "
        f"bit for bit {best_same}, last {last_same}; Adam moments bit for "
        f"bit {adam_same} ({len(live['adam'].exp_avg)} stepped tensors, "
        f"{len(fe_zero)} never stepped (the frozen FE) written as zeros); "
        f"meta step {meta['step']}")
    if not (dtypes == {"float32"} and str(adam_raw["count"].dtype) == "int32"
            and int(adam_raw["count"]) == CKPT_STEPS == meta["step"]
            and best_same and last_same and adam_same and fe_zero
            and all(k.startswith("wav2vec2.feature_extractor.")
                    for k in fe_zero)):
        raise AssertionError("15b: the checkpoint does not read back as the "
                             "live state")

    # the next step without the write, twice from the same state (the
    # second measures the card's own run-to-run floor), then a resume of
    # other weights from the files
    lr = epoch_learning_rate(cfg.learning_rate, 1, cfg.num_warmup_epochs,
                             cfg.num_static_epochs, cfg.lr_decay)
    opt_host = step.optimizer.state_dict()
    opt_host["state"] = {i: host_copy(v) for i, v in opt_host["state"].items()}
    want_loss = step(batch, lr)["loss"].item()
    want = host_copy(model.state_dict())
    model.load_state_dict(live["params"])
    step.optimizer.load_state_dict(opt_host)
    step.step_count = CKPT_STEPS
    step(batch, lr)
    again = host_copy(model.state_dict())
    before = live["params"]
    del step, model, live, last_params, adam_back, opt_host
    torch.cuda.empty_cache()
    model = random_aptai(backbone, seed=1)
    step = make_engine(cfg, aptai_loss_fn(), model)
    t0 = time.perf_counter()
    _, hist = fit(cfg, None, model, [batch], lambda epoch: {"m": 1.0},
                  CheckpointManager(root / "run", "m"), model_cfg=model_cfg,
                  log_fn=lambda m: None, engine=step)
    resume_s = time.perf_counter() - t0
    counts = read_counts()
    got = to_host(model.state_dict())
    bits, floor_bits = same_tensors(got, want), same_tensors(again, want)
    gap, floor = update_gap(got, want, before), update_gap(again, want,
                                                           before)
    steps = CKPT_STEPS + 3
    log(f"  15c fit resumed from the files (model of seed 1) for one step "
        f"in {resume_s:.2f} s (its checkpoint {hist[0]['ckpt_seconds']:.2f} "
        f"s): loss {hist[0]['mean_train_loss']:.6f} vs {want_loss:.6f} "
        f"without the write; parameters bit for bit {bits} (update "
        f"relative L2 {gap[0]:.3e}, {len(gap[1])} tensors differ: "
        f"{gap[1][:4]}); the same step repeated from memory bit for bit "
        f"{floor_bits} (relative L2 {floor[0]:.3e}, {len(floor[1])} "
        f"tensors differ: {floor[1][:4]}); cuDNN deterministic; launches "
        f"over the phase's {steps} steps {counts}")
    # bit for bit, unless the card's own repeat differs: then within ten
    # times that floor
    if not (bits or (not floor_bits and gap[0] <= 10 * floor[0])):
        raise AssertionError("15c: the resumed step differs from the step "
                             "taken without the write")
    if not all(counts[k] == backbone.num_hidden_layers * steps
               for k in FLASH):
        raise AssertionError(f"15: launches {counts} over {steps} steps")
    del step, model, got, want, again, before
    torch.cuda.empty_cache()
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts, steps


# -- phase 16 -----------------------------------------------------------------

DP_STEPS = 2  # full-width steps of each wrapper, counted and compared
TIMED_ROUNDS = 3  # then plain, DDP, FSDP alternated, one step each a round
TRACED_STEPS = 2  # then the steps of each under the profiler
FLASH_FWD_KERNEL = "flash_fwd_bf16_kernel"  # csrc/flash_attn_fwd.cu


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def served_agreement_with(model, want, audio, lengths):
    """Phase 3's serving gates between two trained models on one batch:
    the smallest per-TV Pearson and the phoneme argmax agreement of
    ``model.predict`` against ``want.predict`` (eval mode, no gradient)."""
    outs = []
    for m in (model, want):
        m.eval()
        with torch.no_grad():
            out = m.predict(audio, lengths, fields=("tvs_pred",
                                                    "phn_fc_pred"))
        m.train()
        outs.append({k: v.float().cpu().numpy() for k, v in out.items()})
    got, ref = outs
    n = int(got["frame_lengths"].min())
    tv_g = got["tvs_pred"][:, :n].reshape(-1, 9)
    tv_r = ref["tvs_pred"][:, :n].reshape(-1, 9)
    rs = [pearson(tv_g[:, i], tv_r[:, i]) for i in range(9)]
    agree = float(np.mean(got["phn_fc_pred"][:, :n]
                          == ref["phn_fc_pred"][:, :n]))
    return min(rs), agree


def cpu_tree(tree):
    """``tree`` on the host tensor by tensor: one blocking ``.cpu()`` a
    leaf (the fetch ``fetch_pytree`` replaces)."""
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def same_leaves(a, b) -> bool:
    la, lb = list(leaves(a)), list(leaves(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def phase_data_parallel(card):
    """Phase 16: the data axis on one NCCL rank (the card's machine has one
    card; the CPU tests run two gloo ranks). ``init_distributed`` and
    ``make_mesh``; full-width APTAI (bf16, seed 0, 8 x 5 s, dropout and
    SpecAugment on) takes ``DP_STEPS`` steps plain, under DDP
    (``shard_tree``) and under FSDP (``shard_tree(fsdp=True)``), cuDNN
    deterministic: DDP's losses and parameters against the plain step's
    (bit for bit expected on one rank), FSDP's within phase 3's serving
    gates of them, 24 launches of each flash kernel a step, the per-rank
    bytes of parameters and Adam state; then ``TIMED_ROUNDS`` rounds of one
    step of each, alternated, and ``TRACED_STEPS`` steps of each inside
    ``trace_profile`` (both timed by ``StepTimer``), whose trace must name
    the flash forward kernel, and one profiled step of each; ``fetch_pytree`` of the parameters and Adam
    state against ``.cpu()`` leaf by leaf, bit for bit, GB/s of both; the
    card's int8 peak and phase 12's int8 bounds from it. Returns the DDP
    and FSDP steps' launches."""
    log("== phase 16: data parallel and FSDP over torch.distributed, one "
        "NCCL rank")
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    # the plain and DDP steps are held to each other bit for bit; the pos
    # conv's weight gradient may otherwise take an order-free algorithm
    torch.backends.cudnn.deterministic = True
    if not init_distributed(f"127.0.0.1:{free_port()}", 1, 0):
        raise AssertionError("16: init_distributed set up no group")
    try:
        return _phase_data_parallel(card, t_phase)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.distributed.destroy_process_group()


def _wrapped_step(kind, cfg, mesh):
    model = random_aptai(cfg, seed=0)
    if kind == "fsdp":
        model = shard_tree(model, mesh, fsdp=True)
    return TrainStep(model, torch_adam(model),
                     mesh=None if kind == "plain" else mesh)


def _phase_data_parallel(card, t_phase):
    mesh = make_mesh()
    log(f"  16a process group: backend {torch.distributed.get_backend()}, "
        f"world {torch.distributed.get_world_size()}; mesh {mesh}")
    cfg = Wav2Vec2Config(dtype="bfloat16")
    batch = train_batch(cfg)
    layers = cfg.num_hidden_layers
    steps, losses, params, counts, nbytes = {}, {}, {}, {}, {}
    for kind in ("plain", "ddp", "fsdp"):
        step = steps[kind] = _wrapped_step(kind, cfg, mesh)
        reset_counts()
        losses[kind] = [step(batch, 1e-5)["loss"].item()
                        for _ in range(DP_STEPS)]
        counts[kind] = read_counts()
        params[kind] = full_state_dict(step.model)
        if kind != "fsdp":
            params[kind] = cpu_tree(params[kind])
        nbytes[kind] = (tree_bytes(step.model.state_dict()),
                        tree_bytes(step.optimizer.state_dict()["state"]))
        log(f"  16b {kind}: losses {losses[kind]}, launches over "
            f"{DP_STEPS} steps {counts[kind]}; per-rank parameters "
            f"{nbytes[kind][0] / 1e9:.3f} GB, Adam state "
            f"{nbytes[kind][1] / 1e9:.3f} GB")
        if not (all(counts[kind][n] == DP_STEPS * layers for n in FLASH)
                and counts[kind]["fused_conv_ln_gelu"] == 0
                and all(np.isfinite(losses[kind]))):
            raise AssertionError(f"16b {kind}: launches {counts[kind]}, "
                                 f"losses {losses[kind]}")
    audio = torch.as_tensor(batch["audio"]).cuda()
    lengths = torch.as_tensor(batch["audio_lengths"]).cuda()
    for kind in ("ddp", "fsdp"):
        gap = max((params[kind][k].float() - v.float()).abs().max().item()
                  for k, v in params["plain"].items())
        bits = same_tensors(params[kind], params["plain"])
        r_min, agree = served_agreement_with(
            steps[kind].model, steps["plain"].model, audio, lengths)
        log(f"  16c {kind} vs plain after {DP_STEPS} steps: losses equal "
            f"{losses[kind] == losses['plain']} (largest loss difference "
            f"{max(abs(a - b) for a, b in zip(losses[kind], losses['plain'])):.3e}); "
            f"parameters bit for bit {bits}, largest difference {gap:.3e}; "
            f"served per-TV Pearson min {r_min:.6f}, phoneme argmax "
            f"agreement {agree:.4%}")
        if r_min < 0.999 or agree < 0.99:
            raise AssertionError(f"16c: the {kind} step is outside phase "
                                 "3's serving gates of the plain step")
    del params

    timers = {kind: StepTimer(warmup_steps=0) for kind in steps}
    for _ in range(TIMED_ROUNDS):
        for kind, step in steps.items():
            with timers[kind]:
                step(batch, 1e-5)
                torch.cuda.synchronize()
    audio_s = batch["audio"].size / SAMPLE_RATE
    log(f"  16d {TIMED_ROUNDS} rounds of plain, DDP, FSDP alternated, one "
        "step each: " + "; ".join(
            f"{kind} {[round(t * 1e3, 2) for t in timer.times]} ms "
            f"(p50 {timer.p50 * 1e3:.2f}, "
            f"{timer.summary(audio_s)['throughput_per_second']:.1f} train "
            "audio-s/s)" for kind, timer in timers.items())
        + f" on {card}")

    with tempfile.TemporaryDirectory() as trace_dir:
        timers = {kind: StepTimer(warmup_steps=0) for kind in steps}
        reset_counts()
        with trace_profile(trace_dir):
            for kind, step in steps.items():
                for _ in range(TRACED_STEPS):
                    with timers[kind]:
                        step(batch, 1e-5)
                        torch.cuda.synchronize()
        traced = read_counts()
        traces = sorted(Path(trace_dir).glob("*.pt.trace.json"))
        trace_mb = sum(t.stat().st_size for t in traces) / 1e6
        named = bool(traces) and FLASH_FWD_KERNEL in traces[0].read_text()
    summary = {kind: t.summary(units_per_step=audio_s)
               for kind, t in timers.items()}
    log(f"  16d {TRACED_STEPS} steps each inside trace_profile: " + "; ".join(
        f"{kind} {v['mean_step_seconds'] * 1e3:.2f} ms a step (p50 "
        f"{v['p50_step_seconds'] * 1e3:.2f}), "
        f"{v['throughput_per_second']:.1f} train audio-s/s"
        for kind, v in summary.items())
        + f"; trace files {len(traces)} ({trace_mb:.1f} MB), naming "
        f"{FLASH_FWD_KERNEL} {named}; launches {traced} on {card}")
    if not (len(traces) == 1 and named and all(
            traced[n] == 3 * TRACED_STEPS * layers for n in FLASH)):
        raise AssertionError("16d: no trace naming the flash forward, or "
                             f"the wrong launches {traced}")
    # where the wrappers' time goes: device kernels against wall time
    for kind, step in steps.items():
        profile_breakdown(lambda: step(batch, 1e-5), f"one {kind} step",
                          top=6)

    plain = steps["plain"]
    tree = {"params": plain.model.state_dict(),
            "adam": plain.optimizer.state_dict()["state"]}
    gb = tree_bytes(tree) / 1e9
    rates = {"cpu": [], "fetch_pytree": []}
    for fn in (cpu_tree, fetch_pytree, cpu_tree, fetch_pytree):
        name = "cpu" if fn is cpu_tree else "fetch_pytree"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = fn(tree)
        rates[name].append(gb / (time.perf_counter() - t0))
        if name == "cpu":
            want = host
        else:
            same = same_leaves(host, want)
            if not same:
                raise AssertionError("16e: fetch_pytree differs from .cpu()")
        del host
    del want
    log(f"  16e fetch_pytree of the parameters and Adam state ({gb:.3f} GB): "
        f"{[round(r, 2) for r in rates['fetch_pytree']]} GB/s, bit for bit "
        f"the leaf-by-leaf .cpu() at {[round(r, 2) for r in rates['cpu']]} "
        f"GB/s (the first .cpu() pass first) on {card}")

    peak = device_peak_int8_tops()
    bounds = [int8_bound(SERVING_ROWS, k, n, SERVING_ROWS * k + k * n
                         + 4 * SERVING_ROWS * n) for k, n in QUANT_GEMMS]
    log(f"  16f device_peak_int8_tops(): {peak} TOP/s for "
        f"{torch.cuda.get_device_name(0)}; phase 12a's int8 bounds at "
        f"M {SERVING_ROWS}: " + "; ".join(
            f"K {k}, N {n}: {bound_us(b)}" for (k, n), b in
            zip(QUANT_GEMMS, bounds)))
    del steps, plain, tree
    torch.cuda.empty_cache()
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"ddp_train_step": (DP_STEPS, counts["ddp"]),
            "fsdp_train_step": (DP_STEPS, counts["fsdp"])}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: device and build")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(s in line for s in ("entry function", "registers",
                                       "spill", "error")):
                log(f"    {name}: {line.strip()}")

    cfg = Wav2Vec2Config(dtype="bfloat16")
    train_lengths = train_batch(cfg)["audio_lengths"]
    train_lengths = cfg.feat_extract_output_lengths(train_lengths).tolist()
    records = phase_kernels(train_lengths)
    t0 = time.perf_counter()
    aptai_model = random_aptai(cfg, seed=0)
    pred = APTAIPredictor(aptai_model)
    log(f"  full-width APTAI (bf16, seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    serving, n_batches = phase_slice(cfg, pred)
    pr_cfg = dataclasses.replace(cfg, fused_feature_extractor=True)
    t0 = time.perf_counter()
    pr_pred = W2V2PRPredictor(random_w2v2_pr(pr_cfg, seed=0))
    log(f"  full-width W2V2PR (bf16, vocab {pr_cfg.vocab_size}, fused "
        f"feature extractor, seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    pr_serving, pr_batches = phase_pr_serving(pr_cfg, pr_pred)
    phase_throughput(cfg, pred, card)
    phase_pr_throughput(pr_cfg, pr_pred, card)
    del pr_pred
    phase_fused_ab(cfg, aptai_model, pred, card)
    del pred, aptai_model
    torch.cuda.empty_cache()
    training, training_fused = phase_train(card)
    pr_training, pr_training_fused, _ = phase_pr_train(card)
    (force_serving, force_batches), (force_fused, force_fused_batches) = \
        phase_force_serving(card)
    force_training = phase_force_train(card)
    (fe_pass, fe_batches), fe_step, (force_pass, force_pass_batches) = \
        phase_data(card)
    with tempfile.TemporaryDirectory() as tmp:
        (trainer_epoch, trainer_steps), aptai_ckpt, force_ckpt = \
            phase_trainers(card, Path(tmp))
        streams, http_one = phase_inference(Path(tmp), aptai_ckpt,
                                            force_ckpt, card)
        with tempfile.TemporaryDirectory() as tmp10:
            pretrain_step, pretrain_step15, (pretrain_epoch,
                                             pretrain_steps) = \
                phase_pretrain(card, Path(tmp10))
        # phase 8's checkpoints stay for the export and the W8A8 app
        late = phase_export(Path(tmp), aptai_ckpt, force_ckpt, card)
        late.update(phase_quant(aptai_ckpt, card))
    variants, variant_step = phase_variants(card)
    late.update(variants)
    with tempfile.TemporaryDirectory() as tmp14:
        prep_epoch, prep_steps = phase_hprc_prep(card, Path(tmp14))
    with tempfile.TemporaryDirectory() as tmp15:
        ckpt_counts, ckpt_steps = phase_checkpoint(card, Path(tmp15))
    data_parallel = phase_data_parallel(card)
    for rec in records:
        name = rec["name"]
        rec["launches"] = (pr_serving if name == "fused_conv_ln_gelu"
                           else training)[name]
        rec["launches_by_path"] = {
            "serving": {"batches": n_batches, "launches": serving[name]},
            "w2v2_pr_serving": {"batches": pr_batches,
                                "launches": pr_serving[name]},
            "train_step": {"steps": 1, "launches": training[name]},
            "train_step_fused_fe": {"steps": 1,
                                    "launches": training_fused[name]},
            "w2v2_pr_train_step": {"steps": 1,
                                   "launches": pr_training[name]},
            "w2v2_pr_train_step_frozen_fused_fe": {
                "steps": 1, "launches": pr_training_fused[name]},
            "force_serving": {"batches": force_batches,
                              "launches": force_serving[name]},
            "force_serving_fused_fe": {"batches": force_fused_batches,
                                       "launches": force_fused[name]},
            "force_train_step": {"steps": 1,
                                 "launches": force_training[name]},
            "fe_cache_pass": {"batches": fe_batches,
                              "launches": fe_pass[name]},
            "aptai_step_from_fe_cache": {"steps": 1,
                                         "launches": fe_step[name]},
            "force_cache_pass_beam_device": {
                "batches": force_pass_batches,
                "launches": force_pass[name]},
            "aptai_trainer_epoch_from_fe_cache": {
                "steps": trainer_steps, "launches": trainer_epoch[name]},
            **{f"stream_{path}": {"groups": streams[kind][1],
                                  "launches": streams[kind][0][name]}
               for path, kind in (("aptai", "aptai"),
                                  ("w2v2_pr_fused_fe", "w2v2_pr"),
                                  ("force", "force_aptai"))},
            "http_serving": {"batches": 1, "launches": http_one[name]},
            "pretrain_step": {"steps": 1, "launches": pretrain_step[name]},
            "pretrain_step_4x15s": {"steps": 1,
                                    "launches": pretrain_step15[name]},
            "pretrain_trainer_epoch": {"steps": pretrain_steps,
                                       "launches": pretrain_epoch[name]},
            "train_step_fused_qkv_non_stable": {
                "steps": 1, "launches": variant_step[name]},
            "aptai_trainer_epoch_from_hprc_prep": {
                "steps": prep_steps, "launches": prep_epoch[name]},
            "aptai_steps_checkpoint_and_resume": {
                "steps": ckpt_steps, "launches": ckpt_counts[name]},
            **{path: {"steps": n, "launches": c[name]}
               for path, (n, c) in data_parallel.items()},
            **{path: {"batches": 1, "launches": counts[name]}
               for path, counts in late.items()}}

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
