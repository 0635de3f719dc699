"""The flash attention backward's share of its roofline (%) in APTAI's
training step, its two kernels (dq, dk/dv) together, over the traced
steps."""

from port_bench.readers import flash_bwd_roofline as read  # noqa: F401
