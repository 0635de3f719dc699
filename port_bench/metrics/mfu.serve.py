"""Model FLOPs of the window's completed work at the utterances' true
lengths, over the window and the card's 989 TFLOP/s bf16 peak (%)."""

from port_bench.readers import mfu_percent as read  # noqa: F401
