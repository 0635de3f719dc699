"""Device operations launched an APTAI training step (kernels, copies,
memsets), counted in the traced steps' device trace."""

from port_bench.readers import launches_per_step as read  # noqa: F401
