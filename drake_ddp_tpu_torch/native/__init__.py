"""Native (C++) host code of the model-build path.

Port of ``drake_ddp_tpu/native``: ``meshproc.cpp`` parses OBJ meshes and
computes their bounding-sphere covers, the same algorithm as
:func:`drake_ddp_tpu_torch.io.mesh.approximate_spheres` (its principal
axis by power iteration instead of an eigendecomposition).  This is host
code, not a device kernel.  The library is built with ``g++`` at first
use into ``build/drake_ddp_tpu_torch/`` at the repository root, named by
a hash of its source; where no ``g++`` is found :func:`sphere_cover`
returns None and the caller runs the Python cover
(:func:`drake_ddp_tpu_torch.io.mesh.cover_mesh`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "meshproc.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "drake_ddp_tpu_torch")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmeshproc-{digest}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    tmp.replace(out)
    return True


def load_meshproc() -> Optional[ctypes.CDLL]:
    """The native mesh library, built at first use; None where it cannot
    be built or loaded (callers run the Python cover)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.meshproc_sphere_cover.restype = ctypes.c_int
    lib.meshproc_sphere_cover.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def sphere_cover(obj_path: str, scale: float = 1.0, max_spheres: int = 4
                 ) -> Optional[List[Tuple[np.ndarray, float]]]:
    """Native sphere cover of an OBJ mesh: [(center (3,), radius), ...];
    None if the library is unavailable or the file holds no vertices."""
    lib = load_meshproc()
    if lib is None:
        return None
    centers = (ctypes.c_double * (3 * max_spheres))()
    radii = (ctypes.c_double * max_spheres)()
    n = lib.meshproc_sphere_cover(str(obj_path).encode(),
                                  ctypes.c_double(scale),
                                  ctypes.c_int(max_spheres), centers, radii)
    if n <= 0:
        return None
    return [(np.array(centers[3 * i:3 * i + 3]), float(radii[i]))
            for i in range(n)]
