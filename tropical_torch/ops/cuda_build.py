"""Build the package's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launch functions that take
device pointers and a stream and return ``cudaGetLastError()`` (those of
``lattice_encode`` and ``device_engine``: the count of kernels launched, or
minus a CUDA error).  They are
compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (listed
in ``.gitignore``) and loaded with ``ctypes``; a library is named by a hash
of its source, the ``csrc/*.cuh`` headers it includes and its flags, so an
edited source or header is rebuilt.  A variant built
with extra ``-D`` macros (an instrumented build for a measurement), or from
another ``.cu`` file (a patched copy, for an ablation), is a library of its
own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple, Union

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{CSRC_DIR}")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}

# a source: the name of csrc/<name>.cu or the path of another .cu file; or
# (source, macros to define) for an instrumented variant
Target = Union[str, Tuple[str, Tuple[str, ...]]]

# the first designs of K2 (a launch a level), of K3 (a thread a value, row or
# edge, int32 flags and torch.cumsum), of K4 (four launches a busy insertion
# and a torch.cumsum) and of K5's pair scan (whole-array searches, no column
# table) and row compaction (a thread a row), which the port never loads:
# chip_smoke.py, scripts/device_engine_variants.py and the tests time or hold
# them beside the designs
LATTICE_FIRST = ("lattice_encode", ("LATTICE_LEVEL_LAUNCH",))
# K4c's first design (the curved path: a selection pass of its own, the
# filter a thread a row, K4's finish with a second override test), beside
# the design's K3-K5
CURVED_FIRST = ("device_engine", ("CURVED_FIRST",))
DEVICE_ENGINE_FIRST = ("device_engine", ("CONNECT_SEARCHES",
                                         "COMPACT_ROW_THREAD",
                                         "SKELETON_CUMSUM",
                                         "SPLIT_FOUR_PASS"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the kernels in " + str(CSRC_DIR))
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _split(target: Target) -> Tuple[str, Tuple[str, ...]]:
    return (target, ()) if isinstance(target, str) else target


def _source(name: str) -> Path:
    return Path(name) if name.endswith(".cu") else CSRC_DIR / f"{name}.cu"


def label(target: Target) -> str:
    """The source's stem, with ``[MACRO,...]`` for a variant."""
    name, defines = _split(target)
    stem = _source(name).stem
    return f"{stem}[{','.join(defines)}]" if defines else stem


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _text(src: Path) -> bytes:
    """The source with the package's headers it includes (``#include
    "name.cuh"``, found in ``csrc/``), each once, after it."""
    out, todo, seen = [], [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        out.append(text)
        todo += [CSRC_DIR / m.decode() for m in
                 re.findall(rb'#include "(\w+\.cuh)"', text)]
    return b"".join(out)


def library_path(target: Target) -> Path:
    name, defines = _split(target)
    src = _source(name)
    digest = hashlib.sha256(_text(src)
                            + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(targets: Iterable[Target]) -> Dict[str, str]:
    """Compile every target that is not built yet, one ``nvcc`` per target,
    all started together.  Returns each compile's output by ``label`` (with
    the ``-Xptxas -v`` register, spill and shared-memory summary); "" if
    already built.  Raises if any compile fails, after every compile has
    ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [_split(t) for t in targets]
    nvcc = None
    running = {}
    for target in targets:
        so = library_path(target)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(target[1]), "-o", str(tmp),
               str(_source(target[0]))]
        running[label(target)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    logs = {label(t): "" for t in targets}
    failed = []
    for name, (proc, tmp, so) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(target: Target) -> ctypes.CDLL:
    """The built library of ``target``, built on first use."""
    key = _split(target)
    lib = _LIBS.get(key)
    if lib is None:
        build([key])
        lib = _LIBS[key] = ctypes.CDLL(str(library_path(key)))
    return lib
