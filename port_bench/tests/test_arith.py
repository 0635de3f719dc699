"""The yardstick's arithmetic against hand counts, and the idle share from a
synthetic trace."""

import pytest

from port_bench import arith, readers, trace

CFG = {"family": "aptai", "hidden_size": 8, "num_hidden_layers": 2,
       "num_attention_heads": 2, "intermediate_size": 16,
       "conv_dim": [4, 4], "conv_kernel": [10, 3], "conv_stride": [5, 2],
       "num_conv_pos_embeddings": 4, "num_conv_pos_embedding_groups": 2,
       "num_tvs": 9, "num_phonemes": 3, "vocab_size": 5}


def test_forward_flops_by_hand():
    # 105 samples: layer 0 gives (105-10)//5+1 = 20 frames, layer 1 9
    assert arith.frames(CFG, 105) == 9
    fe = 2 * 20 * 10 * 1 * 4 + 2 * 9 * 3 * 4 * 4
    proj = 2 * 9 * 4 * 8
    pos = 2 * 9 * 4 * (8 // 2) * 8
    layer = 4 * 2 * 9 * 8 * 8 + 4 * 9 * 9 * 8 + 2 * 2 * 9 * 8 * 16
    heads = 2 * 9 * 8 * (9 + 3) + 2 * 9 * 51 * 9
    assert arith.forward_flops(CFG, 105) == fe + proj + pos + 2 * layer + heads
    assert arith.step_flops(CFG, [105]) == 3 * (fe + proj + pos + 2 * layer
                                                + heads)
    frozen = dict(CFG, freeze_feature_encoder=True)
    assert arith.step_flops(frozen, [105]) == fe + 3 * (proj + pos + 2 * layer
                                                        + heads)


def test_kernel_work_by_hand():
    # two utterances of 3 and 5 frames, 2 heads of 4, 2 layers
    flops, nbytes = arith.flash_fwd_work(CFG, [3, 5])
    assert flops == 2 * 4 * 2 * 4 * (9 + 25)
    assert nbytes == 2 * 2 * 2 * 4 * 4 * 8
    flops, nbytes = arith.flash_bwd_work(CFG, [3, 5])
    assert flops == 2 * 10 * 2 * 4 * (9 + 25)
    assert nbytes == 2 * (2 * 2 * 4 * 8 * 8 + 4 * 2 * 8)
    cfg = dict(CFG, conv_dim=[128, 128], conv_kernel=[10, 3])
    flops, nbytes = arith.fused_conv_work(cfg, [105])
    assert flops == 2 * 9 * 3 * 128 * 128
    assert nbytes == 2 * 3 * 128 * 128 + 12 * 128 + 2 * (20 * 128 + 9 * 128)


def test_work_counts_do_not_wrap():
    """Lengths arriving as numpy int32 (a batch's ``audio_lengths``) count
    as Python ints: no fixed-width sum wraps."""
    import numpy as np

    cfg = dict(CFG, num_hidden_layers=24, num_attention_heads=16,
               hidden_size=1024)
    frames32 = np.full(48, 399, np.int32)
    assert arith.flash_bwd_work(cfg, frames32) == arith.flash_bwd_work(
        cfg, [399] * 48)
    assert arith.flash_bwd_work(cfg, frames32)[0] == 24 * 48 * 10 * 16 * 64 \
        * 399 * 399
    assert arith.step_flops(CFG, np.full(4, 105, np.int32)) == \
        arith.step_flops(CFG, [105] * 4)


def test_bound_and_mfu():
    card = arith.peaks("NVIDIA H100 80GB HBM3")
    s, by = arith.bound_s(989e12, 1.0, card)
    assert s == pytest.approx(1.0) and by == "operations"
    s, by = arith.bound_s(1.0, 3.35e12, card)
    assert s == pytest.approx(1.0) and by == "bytes"
    assert arith.peaks("cpu") is None
    obs = {"card": "NVIDIA H100 80GB HBM3", "window_flops": 989e12 * 5,
           "window_seconds": 10.0}
    assert readers.mfu_percent(obs) == pytest.approx(50.0)
    assert readers.mfu_percent(dict(obs, card="cpu")) is None


def test_idle_from_overlapping_kernels():
    # kernels on [0, 10], [5, 15] (overlapping) and [30, 40] us of a 50 us
    # window: busy 25 us, idle 50 %
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 14,
           "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 0,
           "dur": 50}]
    red = trace.reduce_events(ev, 0.0, 50.0)
    assert red["busy_s"] == pytest.approx(25e-6)
    obs = dict(red, window_s=50e-6)
    assert readers.idle_percent(obs) == pytest.approx(50.0)
    gaps = dict(red["breakdown"]["idle_gaps"])
    assert gaps["step / aten::mm"] == pytest.approx(15e-6)
    assert gaps["step"] == pytest.approx(10e-6)
    assert readers.kernel_seconds(obs, ["a", "b"]) == pytest.approx(20e-6)
    # no device operation: no roofline, never a 0
    assert readers.roofline_percent({"card": "NVIDIA H100 80GB HBM3"},
                                    ["a"], (1, 1)) is None
