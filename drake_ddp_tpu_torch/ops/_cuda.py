"""Build and load the port's CUDA kernel libraries.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Builds happen at first use, from the package's own sources,
into ``build/drake_ddp_tpu_torch/`` at the repository root; the library
name carries a hash of its sources, so an edited source is rebuilt and
an unchanged one is reused.  No fast math: stiff contact amplifies
rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drake_ddp_tpu_torch"
SOURCES = {"megastep": "megastep.cu", "megaroll": "megaroll.cu",
           "megajac": "megajac.cu"}
HEADERS = ("lanestep.cuh", "dual.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (function, argtypes)
LAUNCHERS = {
    "megastep": ("megastep_launch", [_P] * 5 + [_I, _P]),
    "megaroll": ("megaroll_launch", [_P] * 10 + [_I, _I, _P]),
    "megajac": ("megajac_launch", [_P] * 10 + [_I, _I, _P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named kernel libraries (default: all), one ``nvcc`` per
    source, all started together.  Returns {name: ptxas report}
    (registers, shared memory, spill bytes per kernel)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.ddp_table_bytes.restype = _I
        lib.ddp_table_bytes.argtypes = []
        lib.ddp_scratch_per_lane.restype = _I
        lib.ddp_scratch_per_lane.argtypes = [_I] * 7
        fn, argtypes = LAUNCHERS[name]
        getattr(lib, fn).restype = _I
        getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]
