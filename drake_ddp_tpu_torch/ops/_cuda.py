"""Build and load the port's CUDA kernel libraries.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Builds happen at first use, from the package's own sources,
into ``build/drake_ddp_tpu_torch/`` at the repository root; the library
name carries a hash of its sources, so an edited source is rebuilt and
an unchanged one is reused.  No fast math: stiff contact amplifies
rounding.  megaroll and megastep take their team size (threads per lane)
at compile time; ``team`` builds a variant with another one, for the
sweep that chose it (``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drake_ddp_tpu_torch"
SOURCES = {"megastep": "megastep.cu", "megaroll": "megaroll.cu",
           "megajac": "megajac.cu", "megaroll_clocks": "megaroll_clocks.cu"}
HEADERS = ("lanestep.cuh", "dual.cuh")
# sources that include another kernel source (rebuilt when it changes)
INCLUDES = {"megaroll_clocks": ("megaroll.cu",)}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library besides the shared size queries:
# name -> {function: argtypes}; each returns an int (a CUDA error code)
ENTRY_POINTS = {
    "megastep": {"megastep_launch": [_P] * 4 + [_I, _I, _P],
                 "megastep_config": [_I, _I, _P]},
    "megaroll": {"megaroll_launch": [_P] * 9 + [_I] * 5 + [_P],
                 "megaroll_config": [_I] * 4 + [_P]},
    "megajac": {"megajac_launch": [_P] * 10 + [_I, _I, _P]},
    "megaroll_clocks": {"megaroll_clocks_launch": [_P] * 9 + [_I] * 5
                        + [_P, _P]},
}
SIZE_QUERIES = {"ddp_table_bytes": [], "ddp_scratch_per_lane": [_I] * 8,
                "ddp_smem_optin": []}

# a library: its name, or (name, team size) for a team-size variant
Spec = Union[str, Tuple[str, int]]

_LIBS: Dict[Tuple[str, Optional[int]], ctypes.CDLL] = {}


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


def _split(spec: Spec) -> Tuple[str, Optional[int]]:
    return (spec, None) if isinstance(spec, str) else spec


def spec_name(spec: Spec) -> str:
    """``name``, or ``name-team<N>`` for a team-size variant."""
    name, team = _split(spec)
    return name if team is None else f"{name}-team{team}"


def _flags(team: Optional[int]):
    return NVCC_FLAGS + ([f"-DDDP_TEAM={team}"] if team else [])


def _lib_path(spec: Spec) -> Path:
    name, team = _split(spec)
    h = hashlib.sha256()
    for f in (SOURCES[name],) + INCLUDES.get(name, ()) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(_flags(team)).encode())
    return BUILD_DIR / f"lib{spec_name(spec)}-{h.hexdigest()[:16]}.so"


def build(specs: Optional[Iterable[Spec]] = None) -> Dict[str, str]:
    """Build the kernel libraries (default: all, at their own team size),
    one ``nvcc`` per library, all started together.  Returns {spec_name:
    ptxas report} (registers, shared memory, spill bytes per kernel)."""
    specs = list(SOURCES if specs is None else specs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        out = _lib_path(spec)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        name, team = _split(spec)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *_flags(team), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[spec_name(spec)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {spec_name(spec): _lib_path(spec).with_suffix(".log").read_text()
            for spec in specs}


def load(name: str, team: Optional[int] = None) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (with team size ``team``, if
    given), built first if needed."""
    key = (name, team)
    if key not in _LIBS:
        spec = name if team is None else key
        path = _lib_path(spec)
        if not path.exists():
            build([spec])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in {**SIZE_QUERIES, **ENTRY_POINTS[name]}.items():
            getattr(lib, fn).restype = _I
            getattr(lib, fn).argtypes = argtypes
        _LIBS[key] = lib
    return _LIBS[key]
