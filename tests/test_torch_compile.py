"""``keep_tpu_torch.utils.compile`` on the CPU: ``nvcc_options`` against the
JAX package's ``tpu_compiler_options`` (None off the accelerator), the
ptxas report's parser on a report in ptxas's format, the build keeping
that report beside the library (a stand-in ``nvcc`` that prints it), the
resource records and the dump from it, and the refusals without a card or
a report. Also the last public names of ``keep_tpu/configs.py``:
``WSIConfig`` and ``asdict``."""

import json
import os
import stat
import sys
import textwrap

import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.utils.compile import tpu_compiler_options
from keep_tpu_torch import configs
from keep_tpu_torch.kernels import _build
from keep_tpu_torch.utils import compile as kcompile

# ptxas -v's report of one source as the card's toolkit (CUDA 12.9) writes
# it, its lines taken from a build of ``csrc/`` with the names shortened: a
# performance note before the entries, an entry that spills (its stack as
# "cumulative stack size"), a device function that was not inlined (not an
# entry), and an entry with static shared memory
REPORT = textwrap.dedent("""\
    ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_Z11attn_kernelILi128EEvPKfPf'
    ptxas info    : 0 bytes gmem
    ptxas info    : Compiling entry function '_Z11attn_kernelILi128EEvPKfPf' for 'sm_90a'
    ptxas info    : Function properties for _Z11attn_kernelILi128EEvPKfPf
        56 bytes stack frame, 56 bytes spill stores, 68 bytes spill loads
    ptxas info    : Used 255 registers, used 1 barriers, 56 bytes cumulative stack size
    ptxas info    : Compile time = 863.291 ms
    ptxas info    : Function properties for _ZN4kops6helperEf
        8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
    ptxas info    : Compiling entry function '_Z9row_quantPKfPaPfii' for 'sm_90a'
    ptxas info    : Function properties for _Z9row_quantPKfPaPfii
        0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
    ptxas info    : Used 58 registers, used 1 barriers, 42240 bytes smem
    ptxas info    : Compile time = 102.500 ms
    """)


def test_nvcc_options_none_off_the_card_as_tpu_options():
    assert tpu_compiler_options() is None
    assert kcompile.nvcc_options() is None
    assert kcompile.nvcc_options("cpu") is None
    flags = kcompile.nvcc_options("cuda")
    assert flags == list(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    i = flags.index("-Xptxas")
    assert flags[i + 1] == "-v"


def test_parse_ptxas_records():
    text = "== attention.cu ==\n" + REPORT + "== quant.cu ==\n" + \
        REPORT.replace("_Z11attn", "_Z12attn").replace("_Z9row", "_Z10row")
    got = kcompile.parse_ptxas(text)
    assert [(r["mangled"], r["source"]) for r in got] == [
        ("_Z11attn_kernelILi128EEvPKfPf", "attention.cu"),
        ("_Z9row_quantPKfPaPfii", "attention.cu"),
        ("_Z12attn_kernelILi128EEvPKfPf", "quant.cu"),
        ("_Z10row_quantPKfPaPfii", "quant.cu")]
    attn, rows = got[0], got[1]
    assert attn == {"mangled": "_Z11attn_kernelILi128EEvPKfPf",
                    "source": "attention.cu", "arch": "sm_90a",
                    "registers": 255, "spill_stores": 56, "spill_loads": 68,
                    "stack_bytes": 56, "smem_static_bytes": 0,
                    "barriers": 1, "notes": [
                        "C7512: Potential Performance Loss: wgmma.mma_async "
                        "instructions are serialized due to insufficient "
                        "register resources"]}
    assert (rows["registers"], rows["spill_stores"], rows["stack_bytes"],
            rows["smem_static_bytes"], rows["barriers"], rows["notes"]) == \
        (58, 0, 0, 42240, 1, [])
    # each note lands on the entry it names, in its own section
    assert got[2]["notes"] == attn["notes"] and got[3]["notes"] == []
    assert kcompile.parse_ptxas("== empty.cu ==\nptxas info : 0 bytes "
                                "gmem\n") == []
    with pytest.raises(ValueError, match="registers"):
        kcompile.parse_ptxas(REPORT.split("ptxas info    : Used 255")[0])


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` that prints ``REPORT`` for each ``-c`` and writes
    its outputs, a ``cuobjdump`` that prints a SASS line, and the build
    directory under ``tmp_path``."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (tmp_path / "report.txt").write_text(REPORT)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        open(args[args.index("-o") + 1], "w").write("obj")
        if "-c" in args:
            sys.stderr.write(open({str(tmp_path / "report.txt")!r}).read())
        """))
    dump = bin_dir / "cuobjdump"
    dump.write_text(f"#!{sys.executable}\nprint('Function : _Z9row_quant')\n")
    for f in (nvcc, dump):
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library", lambda: None)
    return tmp_path


def test_build_keeps_the_report_beside_the_library(fake_toolkit, monkeypatch):
    """``_build._compile`` writes ptxas's report of every ``.cu`` beside
    the library; ``kernel_resources`` gives one record per entry of each
    source, demangled, and ``dump_kernels`` writes the records, the report
    and the SASS."""
    target = _build.library_path()
    _build._compile(target)
    assert target.exists() and _build.report_path().exists()
    assert _build.report_path().parent == target.parent
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    recs = kcompile.kernel_resources()
    assert sorted({r["source"] for r in recs}) == sources
    assert len(recs) == 2 * len(sources)
    assert list(recs[0]) == ["name", "mangled", "source", "arch",
                             "registers", "spill_stores", "spill_loads",
                             "stack_bytes", "smem_static_bytes", "barriers",
                             "notes"]
    names = {r["name"] for r in recs}
    if names != {r["mangled"] for r in recs}:  # a demangler was found
        assert names == {"void attn_kernel<128>(float const*, float*)",
                         "row_quant(float const*, signed char*, float*, "
                         "int, int)"}
    paths = kcompile.dump_kernels(str(fake_toolkit / "dump"))
    with open(paths["resources"]) as f:
        assert json.load(f) == recs
    assert open(paths["ptxas_log"]).read() == \
        _build.report_path().read_text()
    assert "Function : _Z9row_quant" in open(paths["sass"]).read()
    os.remove(_build.report_path())
    with pytest.raises(RuntimeError, match="no ptxas report"):
        kcompile.kernel_resources()


def test_kernel_resources_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        kcompile.kernel_resources()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        kcompile.dump_kernels("unused")


def test_dump_kernels_names_a_missing_cuobjdump(fake_toolkit, monkeypatch):
    _build._compile(_build.library_path())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    os.remove(fake_toolkit / "cuda" / "bin" / "cuobjdump")
    monkeypatch.setenv("PATH", str(fake_toolkit / "cuda" / "bin"))
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        kcompile.dump_kernels(str(fake_toolkit / "dump"))


@pytest.mark.parametrize("fields", [{}, dict(patch_size=224, threshold=0.3,
                                             prompt_screening=False)])
def test_wsi_config_equals_jax(fields):
    """``WSIConfig``'s fields and defaults and ``asdict`` are the JAX
    package's."""
    got, want = configs.WSIConfig(**fields), jcfgs.WSIConfig(**fields)
    assert configs.asdict(got) == jcfgs.asdict(want)
    assert [f.name for f in configs.dataclasses.fields(got)] == \
        [f.name for f in jcfgs.dataclasses.fields(want)]
    with pytest.raises(Exception):
        got.threshold = 0.1  # frozen, as JAX's
