"""What the card's compiler is asked for and what it made of each kernel
(counterpart of ``keep_tpu/utils/compile.py`` and of
``keep_tpu/utils/profiling.enable_hlo_dump``).

- ``nvcc_options()``: the flags the hand-written kernels are built with on
  the card (``kernels._build.NVCC_FLAGS``), or None off the card, as the
  JAX module's ``tpu_compiler_options`` returns XLA's options on a TPU and
  None elsewhere.
- ``kernel_resources()``: one record per ``__global__`` function of the
  built kernel library, from ptxas's own report (``-Xptxas -v``, kept
  beside the library by the build): registers a thread, spill stores and
  loads, stack bytes, static shared memory. Dynamic shared memory is set
  at launch and is not in the report. This is the view of occupancy the
  card's machine gives where no profiler of the kernels runs.
- ``dump_kernels(dump_dir)``: that report, its records as JSON and the
  library's SASS (``cuobjdump -sass``), the counterpart of an HLO dump.
- ``parse_ptxas(text)``: the report's parser, a pure function of its text.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from keep_tpu_torch.kernels import _build

_SECTION = re.compile(r"^== (\S+) ==$")
_ENTRY = re.compile(r"Compiling entry function '([^']+)' for '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_BARRIERS = re.compile(r"used (\d+) barriers")
# "(C7512) Potential Performance Loss: wgmma.mma_async instructions are
# serialized ... for the function '<mangled>'" and the like
_NOTE = re.compile(r"\((C\d+)\) (.*?)(?: for the function '([^']+)')?\s*$")


def nvcc_options(device=None) -> Optional[list[str]]:
    """The nvcc flags of the kernels on ``device`` (default: the card when
    there is one); None where the device is not a CUDA card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return None
    return list(_build.NVCC_FLAGS)


def parse_ptxas(text: str) -> list[dict]:
    """The kernels of a ptxas ``-v`` report: one record per entry function
    (a ``__global__`` function, each template instance apart), in the
    report's order, with the source named by the section it sits in
    (``_build.REPORT_SECTION``) and ``notes``: ptxas's coded messages that
    name it (``"C7512: Potential Performance Loss: wgmma.mma_async
    instructions are serialized ..."``). Device functions that were not
    inlined have properties too; they are not entries and are left out."""
    out: list[dict] = []
    notes: dict[str, list[str]] = {}
    source, entry, props_of_entry = None, None, False
    for line in text.splitlines():
        m = _SECTION.match(line.strip())
        if m:
            source, entry = m.group(1), None
            continue
        m = _NOTE.search(line)
        if m and m.group(3):
            notes.setdefault(m.group(3), []).append(
                f"{m.group(1)}: {m.group(2)}")
            continue
        m = _ENTRY.search(line)
        if m:
            entry = {"mangled": m.group(1), "source": source,
                     "arch": m.group(2), "registers": None,
                     "spill_stores": 0, "spill_loads": 0, "stack_bytes": 0,
                     "smem_static_bytes": 0, "barriers": 0, "notes": []}
            out.append(entry)
            props_of_entry = False
            continue
        m = _PROPS.search(line)
        if m:
            props_of_entry = entry is not None and m.group(1) == \
                entry["mangled"]
            continue
        m = _FRAME.search(line)
        if m:
            if props_of_entry:
                entry["stack_bytes"], entry["spill_stores"], \
                    entry["spill_loads"] = (int(g) for g in m.groups())
            continue
        m = _USED.search(line)
        if m and entry is not None and entry["registers"] is None:
            entry["registers"] = int(m.group(1))
            smem, bars = _SMEM.search(line), _BARRIERS.search(line)
            entry["smem_static_bytes"] = int(smem.group(1)) if smem else 0
            entry["barriers"] = int(bars.group(1)) if bars else 0
    missing = [e["mangled"] for e in out if e["registers"] is None]
    if missing:
        raise ValueError(f"ptxas report: no 'Used N registers' line for "
                         f"{missing}")
    for e in out:
        e["notes"] = notes.get(e["mangled"], [])
    return out


def _tool(name: str) -> Optional[str]:
    """A tool of the toolkit that builds the kernels (beside its nvcc),
    else one on PATH."""
    beside = Path(_build._nvcc()).parent / name
    return str(beside) if beside.exists() else shutil.which(name)


def _demangle(names: list[str]) -> list[str]:
    """C++ names of the mangled ``names`` (``cu++filt``, else ``c++filt``;
    as they are where neither is found)."""
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    done = subprocess.run([tool], input="\n".join(names) + "\n",
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()
    return done if len(done) == len(names) else list(names)


def kernel_resources() -> list[dict]:
    """One record per ``__global__`` function of the kernel library, built
    first if its sources changed: ``name`` (demangled), ``mangled``,
    ``source`` (the ``.cu`` file), ``arch``, ``registers``,
    ``spill_stores``, ``spill_loads``, ``stack_bytes``,
    ``smem_static_bytes``, ``barriers``, ``notes`` (ptxas's performance
    messages about it). Raises without a card (the kernels
    are built for ``sm_90a`` on the card's machine only) or where the
    library has no report beside it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kernel_resources needs a CUDA card: the kernels are built with "
            "nvcc for sm_90a on the card's machine, and this process sees "
            "no card")
    _build.library()
    report = _build.report_path()
    if not report.exists():
        raise RuntimeError(
            f"no ptxas report {report.name} beside "
            f"{_build.library_path().name}: that library was built without "
            f"one; remove it from {_build.BUILD_DIR} to rebuild")
    records = parse_ptxas(report.read_text())
    if not records:
        raise RuntimeError(f"{report} names no kernel")
    names = _demangle([r["mangled"] for r in records])
    return [{"name": n, **r} for n, r in zip(names, records)]


def dump_kernels(dump_dir: str) -> dict:
    """Writes into ``dump_dir`` what the card's compiler made of every
    kernel: ``resources.json`` (``kernel_resources()``), ``ptxas.log``
    (ptxas's report as the build kept it) and ``kernels.sass``
    (``cuobjdump -sass`` of the library). Returns the three paths. Raises
    naming ``cuobjdump`` where the toolkit has none."""
    records = kernel_resources()
    cuobjdump = _tool("cuobjdump")
    if cuobjdump is None:
        raise RuntimeError(
            f"cuobjdump not found beside {_build._nvcc()} nor on PATH: the "
            f"SASS dump needs the CUDA toolkit's cuobjdump")
    os.makedirs(dump_dir, exist_ok=True)
    paths = {k: os.path.join(dump_dir, f) for k, f in (
        ("resources", "resources.json"), ("ptxas_log", "ptxas.log"),
        ("sass", "kernels.sass"))}
    with open(paths["resources"], "w") as f:
        json.dump(records, f, indent=1)
    shutil.copyfile(_build.report_path(), paths["ptxas_log"])
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    with open(paths["sass"], "w") as f:
        f.write(sass)
    return paths
