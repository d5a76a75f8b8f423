"""Wavefront OBJ loading and bounding-sphere covers of collision meshes.

Port of ``drake_ddp_tpu/io/mesh.py``.  The contact pipeline is
sphere-based (contact/geometry.py), so a mesh collision is approximated
on the host by a few bounding spheres: the vertices are sliced along
their principal axis and each slice gets a Ritter bounding sphere.
:func:`cover_mesh` runs the native cover (:mod:`drake_ddp_tpu_torch.
native`) where it builds and this module's otherwise, and says which ran.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


def load_obj_vertices(path: str) -> np.ndarray:
    """Parse an OBJ file's vertex positions -> (V, 3) float64."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
    if not verts:
        raise ValueError(f"no vertices in OBJ file {path}")
    return np.asarray(verts, np.float64)


def _ritter_sphere(verts: np.ndarray) -> Tuple[np.ndarray, float]:
    """Ritter's approximate minimal bounding sphere of a point set."""
    p0 = verts[0]
    p1 = verts[np.argmax(np.linalg.norm(verts - p0, axis=1))]
    p2 = verts[np.argmax(np.linalg.norm(verts - p1, axis=1))]
    center = 0.5 * (p1 + p2)
    radius = 0.5 * float(np.linalg.norm(p2 - p1))
    # grow to include outliers
    for _ in range(2):
        d = np.linalg.norm(verts - center, axis=1)
        i = int(np.argmax(d))
        if d[i] <= radius + 1e-12:
            break
        new_r = 0.5 * (radius + d[i])
        center = center + (d[i] - new_r) / d[i] * (verts[i] - center)
        radius = new_r
    return center, radius


def approximate_spheres(
    verts: np.ndarray, max_spheres: int = 4, refine: float = 1.0
) -> List[Tuple[np.ndarray, float]]:
    """Approximate a vertex cloud by <= max_spheres bounding spheres.

    Slices the cloud along its principal axis into k segments, k growing
    with the cloud's elongation (extent over cross-section, times
    ``refine``), and bounds each slice with a Ritter sphere.  Returns
    [(center (3,), radius), ...] in the mesh's own frame.  Each slice's
    sphere covers its whole cross-section, so the cover stays bounding.
    """
    mean = verts.mean(axis=0)
    centered = verts - mean
    # principal axis: the covariance's leading eigenvector
    cov = centered.T @ centered / max(len(verts), 1)
    _, V = np.linalg.eigh(cov)
    axis = V[:, -1]
    t = centered @ axis
    extent = float(t.max() - t.min())
    # cross-sectional scale: rms distance from the axis
    radial = centered - t[:, None] * axis[None, :]
    cross = 2.0 * float(np.sqrt((radial ** 2).sum(axis=1).mean()) + 1e-9)
    k = int(np.clip(np.ceil(refine * extent / max(cross, 1e-6)),
                    1, max_spheres))
    if k == 1:
        c, r = _ritter_sphere(verts)
        return [(c, r)]
    edges = np.linspace(t.min() - 1e-9, t.max() + 1e-9, k + 1)
    out = []
    for i in range(k):
        sel = (t >= edges[i]) & (t <= edges[i + 1])
        if sel.sum() < 2:
            continue
        out.append(_ritter_sphere(verts[sel]))
    return out or [_ritter_sphere(verts)]


class MeshCover(NamedTuple):
    """A mesh's bounding spheres and the code that computed them:
    ``"native"`` (the C++ library) or ``"python"``."""

    spheres: List[Tuple[np.ndarray, float]]
    route: str


def cover_mesh(path: str, scale: float = 1.0, max_spheres: int = 4,
               refine: float = 1.0) -> MeshCover:
    """Bounding spheres of the OBJ mesh at ``path`` scaled by ``scale``:
    the native cover where its library builds (``refine`` 1 only: its C
    interface has no refine), else :func:`approximate_spheres`."""
    if refine == 1.0:
        from drake_ddp_tpu_torch.native import sphere_cover
        spheres = sphere_cover(path, scale, max_spheres)
        if spheres is not None:
            return MeshCover(spheres, "native")
    verts = load_obj_vertices(path) * scale
    return MeshCover(approximate_spheres(verts, max_spheres, refine=refine),
                     "python")
