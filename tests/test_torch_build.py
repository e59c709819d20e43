"""The kernels' build names each library by a hash of what it compiles.

``_build._target`` hashes a source, every local header it includes
(``#include "..."``, followed recursively, as ``kernels/hopper.cuh`` is
included by three sources) and the nvcc flags, so an edited header never
loads a stale library.  Run on the CPU: nothing is compiled.
"""
import pytest

from repro_torch.kernels import _build


def _tree(tmp_path):
    (tmp_path / "k" / "csrc").mkdir(parents=True)
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\nint a;\n')
    (tmp_path / "inner.cuh").write_text("int b;\n")
    src = tmp_path / "k" / "csrc" / "k.cu"
    src.write_text('#include "../../common.cuh"\n  #  include "../../common.cuh"\n'
                   "#include <cuda_runtime.h>\nint main() { return 0; }\n")
    return src


def test_includes_are_followed_once_and_in_order(tmp_path):
    src = _tree(tmp_path)
    assert _build.includes(src) == [(tmp_path / "common.cuh").resolve(),
                                    (tmp_path / "inner.cuh").resolve()]


@pytest.mark.parametrize("edit", ["common.cuh", "inner.cuh", "k/csrc/k.cu"])
def test_editing_an_included_header_renames_the_library(tmp_path, edit):
    src = _tree(tmp_path)
    before = _build._target(src)
    assert before.name.startswith("k-") and before.suffix == ".so"
    assert _build._target(src) == before               # stable
    path = tmp_path / edit
    path.write_text(path.read_text() + "// edited\n")
    assert _build._target(src) != before


def test_port_sources_include_the_shared_header():
    """Every library includes ``hopper.cuh``; ``flash_attention.cu`` and
    ``ssd_scan.cu`` also their backwards, ``flash_attention_bwd.cuh`` and
    ``ssd_scan_bwd.cuh``, built into the same library."""
    hopper = (_build._PKG / "hopper.cuh").resolve()
    incl = {name: _build.includes(src) for name, src in _build.sources().items()}
    for name in ("hybrid_attention", "kv_gen"):
        assert incl[name] == [hopper]
    for name in ("flash_attention", "ssd_scan"):
        assert incl[name] == [
            hopper, (_build.sources()[name].parent / f"{name}_bwd.cuh").resolve()]
