"""The flash attention forward's share of its roofline (%), over the traced
batches: the least time for the products and bytes that the utterances'
valid frames need, over the profiled time of ``flash_fwd_bf16``."""

from port_bench import arith
from port_bench.readers import roofline_percent, traced_frames


def read(obs):
    if "traced_lengths" not in obs:
        return None
    return roofline_percent(obs, ["flash_fwd_bf16"], arith.flash_fwd_work(
        obs["cfg"], traced_frames(obs)))
