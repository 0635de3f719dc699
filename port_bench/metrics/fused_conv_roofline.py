"""The fused conv + LayerNorm + GELU kernel's share of its roofline (%),
over the traced batches: the least time for the products and bytes the
utterances' valid samples need in the fused layers, over the profiled time
of ``fused_conv_ln_gelu_bf16``."""

from port_bench import arith
from port_bench.readers import roofline_percent


def read(obs):
    if "traced_lengths" not in obs:
        return None
    return roofline_percent(obs, ["fused_conv_ln_gelu_bf16"],
                            arith.fused_conv_work(obs["cfg"],
                                                  obs["traced_lengths"]))
