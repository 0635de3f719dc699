"""What the per-layer readers (``metrics/<name>.py``) share. Each takes the
run's observations and returns the metric, or None where there is nothing
to read; a share of a roofline or of a peak is never made up as 0."""

from __future__ import annotations

from typing import Optional, Sequence

from port_bench import arith


def idle_percent(obs) -> Optional[float]:
    """The share of the traced segment in which no operation ran on the
    device (the union of their intervals)."""
    if not obs.get("window_s") or "busy_s" not in obs:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])


def kernel_seconds(obs, names: Sequence[str]) -> float:
    """Device seconds of the kernels whose name contains one of ``names``."""
    return sum(rec["seconds"] for k, rec in obs.get("kernels", {}).items()
               if any(n in k for n in names))


def roofline_percent(obs, names: Sequence[str], work) -> Optional[float]:
    """The least time the card could take for ``work`` = (operations,
    bytes), over the profiled time of the kernels ``names``."""
    peaks = arith.peaks(obs.get("card", ""))
    seconds = kernel_seconds(obs, names)
    if peaks is None or seconds <= 0:
        return None
    least, _ = arith.bound_s(*work, peaks)
    return 100.0 * least / seconds


def traced_frames(obs):
    return [arith.frames(obs["cfg"], n) for n in obs["traced_lengths"]]


def mfu_percent(obs) -> Optional[float]:
    """Model FLOPs of the window's completed work over the window and the
    card's bf16 peak."""
    peaks = arith.peaks(obs.get("card", ""))
    if peaks is None or not obs.get("window_flops"):
        return None
    return 100.0 * obs["window_flops"] / obs["window_seconds"] / peaks[
        "bf16_flops"]


def launches_per_step(obs) -> Optional[float]:
    """Device operations launched a traced unit (kernels, copies,
    memsets), counted in the device trace."""
    steps = obs.get("traced_units")
    if not steps or not obs.get("kernels"):
        return None
    return sum(k["launches"] for k in obs["kernels"].values()) / steps


def flash_bwd_roofline(obs) -> Optional[float]:
    """The flash attention backward's share of its roofline, its two
    kernels (dq, dk/dv) together: the least time for the backward's five
    products and bytes over the valid frames, over the profiled time of
    ``flash_bwd_dq_bf16`` and ``flash_bwd_dkv_bf16``."""
    if "traced_lengths" not in obs:
        return None
    return roofline_percent(obs, ["flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"],
                            arith.flash_bwd_work(obs["cfg"],
                                                 traced_frames(obs)))
