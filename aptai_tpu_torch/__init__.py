"""aptai_tpu_torch — the APTAI speech framework in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX one (``aptai_tpu``), held against it by the
parity tests in ``tests/test_torch_*.py``. It imports ``torch`` and numpy
only. Module names mirror the JAX package so each counterpart is easy to
find:

``aptai_tpu_torch.ops``     attention (flash forward and backward kernels +
                            plain versions), the fused conv, CTC, FIR,
                            ForwardSum, the packed (bi)LSTM
``aptai_tpu_torch.models``  config, wav2vec2 encoder, APTAI heads and loss,
                            W2V2PR, FORCE-APTAI and its head modules,
                            weight bridge
``aptai_tpu_torch.train``   ``torch_adam``, ``TrainStep`` with the loss
                            adapters of the three families, FORCE's
                            frozen-tower cache, the LR schedule, the
                            validation passes and metrics
``aptai_tpu_torch.decode``  the CTC beam search (C++ first), its padded
                            batch form and the edit distance
``aptai_tpu_torch.infer``   the predictors and the ``MicroBatcher``
``aptai_tpu_torch.parallel`` data parallelism and FSDP over
                            ``torch.distributed``, one process per device
``aptai_tpu_torch.utils``   run logging, profiling, tree helpers, plotting,
                            FLOP count and device peaks
``aptai_tpu_torch/csrc``    CUDA sources, built with ``nvcc`` at first use

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

TV_ORDER = ("LA", "LP", "JA", "TTCL", "TTCD", "TMCL", "TMCD", "TBCL", "TBCD")
"""Canonical ordering of the 9 articulatory tract variables: lip aperture,
lip protrusion, jaw aperture, tongue tip / mid / body constriction location
and degree."""

BLANK_ID = 0
"""CTC blank index."""

FRAME_RATE_HZ = 49
"""Nominal encoder frame rate for 16 kHz input with conv strides
[5,2,2,2,2,2,2] (20 ms hop)."""

SAMPLE_RATE = 16_000
"""All audio is 16 kHz."""

AUDIO_PAD_VALUE = 0.0
PHONEME_FRAME_PAD_ID = 0      # also the CE ignore_index
TV_PAD_VALUE = -100.0         # MSE mask sentinel
CTC_LABEL_PAD_ID = -100       # CTC label padding
