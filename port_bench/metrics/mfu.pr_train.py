"""Model FLOPs of W2V2PR's completed steps in the window at the utterances'
true lengths, over the window and the card's 989 TFLOP/s bf16 peak (%)."""

from port_bench.readers import mfu_percent as read  # noqa: F401
