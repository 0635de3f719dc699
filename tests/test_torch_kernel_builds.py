"""aptai_tpu_torch's kernel and native libraries, on the CPU: the kernel
library keyed by a hash of its sources (a header edit rebuilds every
kernel), the native library built atomically and keyed by its source, and
the comparison scripts that time two checkouts fit this one."""

import pytest
import torch

from aptai_tpu_torch.ops import attention as tatt


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd",
                                  "fused_conv_ln_gelu"])
def test_kernel_library_is_keyed_by_source_hash(name):
    from aptai_tpu_torch.ops import kernels

    path = kernels.library_path(name)
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert path == kernels.library_path(name)
    assert all((kernels.CSRC / src).exists() for src in kernels.SOURCES[name])


# the chip_smoke, attention, fused_conv and kernels names a comparison turn
# may use: each one existed already when this script was
# compare_attention.py, so older checkouts can be timed too
_PARENT_NAMES = {
    ("cs", "_qkv"), ("cs", "device_ms"), ("cs", "train_batch"),
    ("cs", "time_training_kernels"), ("cs", "fused_operands"),
    ("cs", "fe_input_lengths"), ("cs", "bf16_ulp"),
    ("attention", "flash_attention_bhtd_cuda"),
    ("attention", "flash_attention_bwd_cuda"),
    ("fused_conv", "fused_conv_ln_gelu_cuda"),
    ("fused_conv", "fused_conv_ln_gelu_plain"), ("kernels", "build_all")}


def test_backward_comparison_script_fits_this_checkout():
    """compare_kernels.py runs one snippet in each checkout it times: every
    chip_smoke, attention, fused_conv and kernels name the snippet uses is
    one older checkouts have too, and exists in this one; with no checkout
    to time it prints its usage."""
    import ast

    import chip_smoke
    import compare_kernels
    from aptai_tpu_torch.ops import fused_conv, kernels

    modules = {"cs": chip_smoke, "attention": tatt, "kernels": kernels,
               "fused_conv": fused_conv}
    used = {(node.value.id, node.attr)
            for node in ast.walk(ast.parse(compare_kernels._TURN))
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in modules}
    assert len(used) >= 10
    assert ("attention", "flash_attention_bhtd_cuda") in used
    assert ("fused_conv", "fused_conv_ln_gelu_cuda") in used
    assert used <= _PARENT_NAMES, used - _PARENT_NAMES
    assert all(hasattr(modules[m], name) for m, name in used), used
    assert compare_kernels.main([]) == 2
    assert compare_kernels.main(["--only", "fused_conv"]) == 2


def test_serving_comparison_script_fits_this_checkout():
    """compare_serving.py runs one snippet in each checkout it times: every
    chip_smoke name it uses is one the checkout before the kernels became
    ``torch.library`` ops has too, and exists in this one, as do the
    attention names of its op-only part; with no checkout to time it
    prints its usage."""
    import ast

    import chip_smoke
    import compare_serving

    modules = {"cs": chip_smoke, "attention": tatt}
    used = {(node.value.id, node.attr)
            for node in ast.walk(ast.parse(compare_serving._TURN))
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in modules}
    older = {("cs", n) for n in ("SAMPLE_RATE", "timed_batches",
                                 "synthetic_recording", "http_load", "_qkv",
                                 "profile_breakdown", "device_kernels")}
    assert {m for m, _ in used} == {"cs", "attention"}
    assert {u for u in used if u[0] == "cs"} <= older, used - older
    assert all(hasattr(modules[m], name) for m, name in used), used
    assert compare_serving.main([]) == 2


@pytest.mark.parametrize("header", ["flash_attn_common.cuh",
                                    "wgmma_tiles.cuh", "tma_cluster.cuh"])
def test_header_edit_rebuilds_every_kernel(monkeypatch, tmp_path, header):
    """A library is named by its sources and every header, so an edited
    (or moved) header gives all three kernels new library paths: no stale
    build survives it."""
    import shutil

    from aptai_tpu_torch.ops import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert len(before) == 3 and len(set(before.values())) == 3
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert all(after[n] != before[n] for n in kernels.SOURCES), (before,
                                                                 after)


def test_native_library_builds_atomically_and_is_keyed_by_source(
        monkeypatch, tmp_path):
    """Four concurrent builds of the C++ helpers into one directory (as
    test workers do) leave one loadable library and no partial file; an
    edited source gets a new library path."""
    import ctypes
    import shutil
    import threading

    from aptai_tpu_torch.decode import native

    src = tmp_path / "aptai_native.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    out = native.library_path()
    errors = []

    def build():
        try:
            native._build(out)
        except RuntimeError as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [out.name]
    lib = ctypes.CDLL(str(out))
    assert hasattr(lib, "aptai_ctc_beam_search")
    with open(src, "a") as f:
        f.write("// edited\n")
    assert native.library_path() != out
