"""The benchmark of aptai_tpu_torch on one NVIDIA H100 (see PERF.md)."""
