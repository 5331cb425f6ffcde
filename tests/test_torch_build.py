"""The kernels' C interfaces against the ``ctypes`` signatures that
``kernels/build.py`` declares for them.

A wrapper passes its arguments through ``ctypes`` with the declared
``argtypes``; a launcher whose parameter list has drifted from them would
read garbage on the card, where nothing here can run it.  So each entry
point of ``SIGNATURES`` is looked up in the ``extern "C"`` part of its
``csrc/*.cu`` source and its parameters are counted and typed (pointers
and the stream as ``c_void_p``, ``int`` as ``c_int``, ``long long`` as
``c_longlong``, ``float`` as ``c_float``).
"""
import ctypes
import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_longlong: "long long", ctypes.c_float: "float",
         ctypes.c_char_p: "const char*"}


def _kind(param):
    param = " ".join(param.split())
    if "*" in param or param.startswith("cudaStream_t"):
        return "pointer"
    for kind in ("long long", "int", "float"):
        if param.startswith(kind + " ") or param.startswith("const " + kind
                                                            + " "):
            return kind
    raise AssertionError(f"unknown parameter type: {param!r}")


def _extern_c(source):
    text = (build.CSRC / source).read_text()
    return text[text.index('extern "C" {'):]


@pytest.mark.parametrize("source", build.SOURCES)
def test_c_entry_points_match_their_ctypes_signatures(source):
    body = _extern_c(source)
    for name, (argtypes, restype) in build.SIGNATURES[source].items():
        m = re.search(r"([\w ]+?\*?)\s*\b" + name + r"\(([^)]*)\)\s*\{",
                      body)
        assert m, f"{source}: no entry point {name}"
        params = [p for p in m.group(2).split(",") if p.strip()]
        assert [_kind(p) for p in params] == [KINDS[a] for a in argtypes], \
            f"{source}: {name}({m.group(2)})"
        ret = " ".join(m.group(1).split())
        want = KINDS[restype]
        assert ret.endswith(want) or (want == "const char*"
                                      and ret.endswith("char*")), \
            f"{source}: {name} returns {ret}, declared {want}"


@pytest.mark.parametrize("source", build.SOURCES)
def test_cuda_source_parses_as_cxx17(source, tmp_path):
    """``tools/cu_syntax_check.py`` on each source: g++ parses it, launches
    and inline assembly cut, with every template instantiated (nvcc itself
    runs only on the card's machine)."""
    import shutil
    import sys
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    sys.path.insert(0, str(build.CSRC.parents[3] / "tools"))
    try:
        import cu_syntax_check
    finally:
        sys.path.pop(0)
    cu_syntax_check.write_headers(tmp_path)
    assert cu_syntax_check.check(build.CSRC / source, tmp_path)



def _tool(name):
    """The module ``tools/<name>.py``."""
    import importlib
    import sys
    root = build.CSRC.parents[3]
    sys.path[:0] = [str(root / "tools"), str(root)]
    try:
        return importlib.import_module(name)
    finally:
        del sys.path[:2]


@pytest.mark.parametrize("tool", ["swd_variants", "infonce_variants",
                                  "laplacian_variants", "int8_variants",
                                  "wire_variants", "hybrid_reg_variants",
                                  "flash_fwd_bf16_variants"])
def test_variant_patches_apply_and_parse(tool, tmp_path):
    """Every copy of the kernel source that the tool compiles (the source
    and each variant's text patches, with the occupancy query appended to
    each SWD copy) still applies and parses as C++17, so the rejected
    designs the tool carries stay buildable beside the one shipped."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    mod, check = _tool(tool), _tool("cu_syntax_check")
    patched = _tool("flash_bwd_variants").patched
    text = (build.CSRC / mod.SOURCE).read_text()
    suffix = getattr(mod, "OCCUPANCY", "")
    check.write_headers(tmp_path)
    assert len(mod.VARIANTS) > 2
    for name, subs in {"source": {}, **mod.VARIANTS}.items():
        src = tmp_path / f"{name}.cu"
        src.write_text(patched(text, name, subs) + suffix)
        assert check.check(src, tmp_path), f"{tool}: {name}"


def test_regularisers_backward_has_one_body():
    """The SW and Laplacian gradients live in one kernel,
    ``hybrid_reg_bwd.cu``, which ``swd_rank_bwd`` and
    ``laplacian_energy_bwd`` launch with one half: no other source defines
    a backward kernel or entry point of either term."""
    assert "hybrid_reg_bwd.cu" in build.SOURCES
    for source in build.SOURCES:
        text = (build.CSRC / source).read_text()
        for name in ("swd_rank_bwd", "laplacian_energy_bwd"):
            assert f"{name}_kernel" not in text and f"{name}_f32" not in text
        assert text.count("hybrid_reg_bwd_kernel(") == \
            (1 if source == "hybrid_reg_bwd.cu" else 0)
