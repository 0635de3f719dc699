"""Device operations launched a W2V2PR training step (kernels, copies,
memsets; the CTC loss's frame loop most of them), counted in the traced
steps' device trace."""

from port_bench.readers import launches_per_step as read  # noqa: F401
