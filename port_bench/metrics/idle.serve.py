"""The device's idle share in the traced segment (%): no kernel, copy or
memset running, overlaps counted once."""

from port_bench.readers import idle_percent as read  # noqa: F401
