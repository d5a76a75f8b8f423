"""Collision geometry: host-side scene description -> flat contact tables.

Port of ``drake_ddp_tpu/contact/geometry.py`` (host side).  Every
body-attached geometry but a box is decomposed into spheres; world
geometries (ground planes, walls) stay analytic; body boxes stay boxes
(face contact against halfspaces, closest-point contact against
spheres).  Pair enumeration and collision filtering happen here, at
build time; the device sees fixed-size tables.  The per-scenario
``narrowphase`` is not ported yet: the lane-major narrowphase lives in
:mod:`drake_ddp_tpu_torch.multibody.lanestep` and ``csrc/lanestep.cuh``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device

SPHERE = "sphere"
BOX = "box"
CYLINDER = "cylinder"
CAPSULE = "capsule"
HALFSPACE = "halfspace"


@dataclasses.dataclass(frozen=True)
class ContactProps:
    """Hydroelastic-style material properties (per geometry): modulus E
    [Pa] (np.inf = rigid), Hunt-Crossley dissipation [s/m], Coulomb
    friction, and a resolution hint kept for parity (unused)."""

    modulus: float = 5e6
    dissipation: float = 0.0
    mu_static: float = 0.6
    mu_dynamic: float = 0.5
    resolution_hint: float = 0.05


@dataclasses.dataclass(frozen=True)
class CollisionGeometry:
    """One collision geometry, attached to a body or the world (body=-1).
    size: sphere [r]; box half extents; cylinder/capsule [r, half_length]
    (axis z); halfspace [pressure depth or 0] (normal = rot @ z)."""

    body: int
    kind: str
    pos: np.ndarray
    rot: np.ndarray
    size: np.ndarray
    props: ContactProps = ContactProps()
    name: str = ""


class GeometrySet:
    """Host-side scene: add geometries, filter pairs."""

    def __init__(self):
        self.geoms: List[CollisionGeometry] = []
        self._filtered: List[Tuple[int, int]] = []
        self._filtered_bodies: List[Tuple[int, int]] = []

    def add(self, geom: CollisionGeometry) -> int:
        self.geoms.append(geom)
        return len(self.geoms) - 1

    def exclude_pair(self, gi: int, gj: int):
        self._filtered.append((min(gi, gj), max(gi, gj)))

    def exclude_body_pair(self, bi: int, bj: int):
        """Collision filter between two bodies (Drake ExcludeBetween)."""
        self._filtered_bodies.append((min(bi, bj), max(bi, bj)))


def _decompose_to_spheres(g: CollisionGeometry):
    """Body-frame spheres (offset, radius, pressure length) approximating
    a body-attached sphere, cylinder or capsule."""
    if g.kind == SPHERE:
        return [(g.pos, float(g.size[0]), float(g.size[0]))]
    if g.kind == CYLINDER:
        r, hl = float(g.size[0]), float(g.size[1])
        n = max(2, int(np.ceil(2 * hl / max(r, 1e-6))) + 1)
        n = min(n, 6)
        zs = np.linspace(-max(hl - r, 0.0), max(hl - r, 0.0), n)
        axis = g.rot @ np.array([0.0, 0.0, 1.0])
        return [(g.pos + z * axis, r, r) for z in zs]
    if g.kind == CAPSULE:
        r, hl = float(g.size[0]), float(g.size[1])
        n = min(max(2, int(np.ceil(2 * hl / max(r, 1e-6))) + 1), 6)
        zs = np.linspace(-hl, hl, n)
        axis = g.rot @ np.array([0.0, 0.0, 1.0])
        return [(g.pos + z * axis, r, r) for z in zs]
    raise ValueError(f"cannot decompose {g.kind} attached to a body")


class ContactModel(NamedTuple):
    """Flat contact tables: static index tuples + float32 tensors.

    Spheres (body-attached): ns entries.  World halfspaces (nh), boxes
    (world-fixed with box_body -1 and a world pose, or body-attached with
    a body-frame pose), world spheres.  Candidate pairs are index tuples
    with per-pair constants: K = pi * r * g_eff (quadratic law), g (the
    series-combined pressure gradient of the linear box-face law), d and
    mu (see contact/forces.py)."""

    sph_body: Tuple[int, ...]
    sph_offset: torch.Tensor       # (ns, 3) body frame
    sph_radius: torch.Tensor       # (ns,)
    hs_normal: torch.Tensor        # (nh, 3)
    hs_offset: torch.Tensor        # (nh,)   x . normal >= offset outside
    box_body: Tuple[int, ...]
    box_rot: torch.Tensor          # (nbx, 3, 3)
    box_pos: torch.Tensor          # (nbx, 3)
    box_half: torch.Tensor         # (nbx, 3)
    ws_pos: torch.Tensor           # (nws, 3)
    ws_radius: torch.Tensor        # (nws,)
    pair_sh_s: Tuple[int, ...]     # sphere - halfspace
    pair_sh_h: Tuple[int, ...]
    sh_K: torch.Tensor
    sh_d: torch.Tensor
    sh_mu: torch.Tensor
    pair_sb_s: Tuple[int, ...]     # sphere - box
    pair_sb_b: Tuple[int, ...]
    sb_K: torch.Tensor
    sb_d: torch.Tensor
    sb_mu: torch.Tensor
    pair_ss_a: Tuple[int, ...]     # sphere - sphere
    pair_ss_b: Tuple[int, ...]
    ss_K: torch.Tensor
    ss_d: torch.Tensor
    ss_mu: torch.Tensor
    pair_sw_s: Tuple[int, ...]     # body sphere - world sphere
    pair_sw_w: Tuple[int, ...]
    sw_K: torch.Tensor
    sw_d: torch.Tensor
    sw_mu: torch.Tensor
    pair_bh_b: Tuple[int, ...]     # body box face - halfspace (8 corners)
    pair_bh_h: Tuple[int, ...]
    bh_g: torch.Tensor
    bh_d: torch.Tensor
    bh_mu: torch.Tensor
    pair_bs_b: Tuple[int, ...] = ()  # body box face - body sphere (8)
    pair_bs_s: Tuple[int, ...] = ()
    bs_g: Optional[torch.Tensor] = None
    bs_d: Optional[torch.Tensor] = None
    bs_mu: Optional[torch.Tensor] = None

    @property
    def num_contacts(self) -> int:
        return (len(self.pair_sh_s) + len(self.pair_sb_s)
                + len(self.pair_ss_a) + len(self.pair_sw_s)
                + 8 * len(self.pair_bh_b) + 8 * len(self.pair_bs_b))


def _series_gradient(pa: ContactProps, la: float, pb: ContactProps,
                     lb: float):
    """Series-combined pressure gradient g_eff (g = E/l per side, rigid =
    inf passes the other through) + Drake's dissipation-sum and
    harmonic-friction rules."""
    ga = np.inf if np.isinf(pa.modulus) else pa.modulus / max(la, 1e-9)
    gb = np.inf if np.isinf(pb.modulus) else pb.modulus / max(lb, 1e-9)
    if np.isinf(ga) and np.isinf(gb):
        g = 1e10  # rigid-rigid: huge but finite
    elif np.isinf(ga):
        g = gb
    elif np.isinf(gb):
        g = ga
    else:
        g = ga * gb / (ga + gb)
    d = pa.dissipation + pb.dissipation
    ma, mb = max(pa.mu_dynamic, 1e-8), max(pb.mu_dynamic, 1e-8)
    mu = 2.0 * ma * mb / (ma + mb)
    return g, d, mu


def _combine(pa: ContactProps, la: float, pb: ContactProps, lb: float,
             r_patch: float):
    """Quadratic-law pair constants: K = pi * r_patch * g_eff, d, mu."""
    g, d, mu = _series_gradient(pa, la, pb, lb)
    return np.pi * r_patch * g, d, mu


HALFSPACE_PRESSURE_DEPTH = 0.5
"""Default pressure-field depth scale of a compliant world halfspace [m]
(a Box(25, 25, 1) ground -> mid-plane depth 0.5)."""


def build_contact_model(gs: GeometrySet, dtype=torch.float32,
                        box_face_quadrature: bool = False,
                        device="cuda") -> Optional[ContactModel]:
    """Decompose, enumerate filtered candidate pairs, build the tables
    (None when the scene has no candidate pair).

    ``box_face_quadrature`` routes body-box-vs-sphere candidates to the
    8-corner box-face law (bs pairs) instead of closest-point contact
    (sb pairs)."""
    dev = resolve_device(device)
    spheres = []      # (body, offset, radius, props, src, ell)
    halfspaces = []   # (normal, offset, props, src, ell)
    boxes = []        # (body, rot, pos, half, props, src, ell)
    wspheres = []     # (pos, radius, props, src)
    for gi, g in enumerate(gs.geoms):
        if g.body < 0:
            if g.kind == HALFSPACE:
                n = g.rot @ np.array([0.0, 0.0, 1.0])
                ell = (float(g.size[0]) if float(g.size[0]) > 0
                       else HALFSPACE_PRESSURE_DEPTH)
                halfspaces.append((n, float(n @ g.pos), g.props, gi, ell))
            elif g.kind == BOX:
                boxes.append((-1, g.rot, g.pos, g.size.astype(float),
                              g.props, gi, float(np.min(g.size))))
            elif g.kind == SPHERE:
                wspheres.append((np.asarray(g.pos, float),
                                 float(g.size[0]), g.props, gi))
            else:
                raise ValueError(f"unsupported world geometry {g.kind}")
        elif g.kind == BOX:
            boxes.append((g.body, g.rot, g.pos, g.size.astype(float),
                          g.props, gi, float(np.min(g.size))))
        else:
            for off, r, ell in _decompose_to_spheres(g):
                spheres.append((g.body, np.asarray(off, float), float(r),
                                g.props, gi, ell))

    filt = set(gs._filtered)
    bfilt = set(gs._filtered_bodies)

    def filtered(src_i, src_j, body_i, body_j):
        key = (min(src_i, src_j), max(src_i, src_j))
        bkey = (min(body_i, body_j), max(body_i, body_j))
        return key in filt or bkey in bfilt

    pair_sh, pair_sb, pair_ss, pair_sw, pair_bh, pair_bs = \
        [], [], [], [], [], []
    for si, (b, off, r, props, src, ell) in enumerate(spheres):
        for hi, (n, o, hprops, hsrc, hell) in enumerate(halfspaces):
            if not filtered(src, hsrc, b, -1):
                pair_sh.append((si, hi,
                                *_combine(props, ell, hprops, hell, r)))
        for bi, (bbody, R, p, half, bprops, bsrc, bell) in enumerate(boxes):
            if bbody != b and not filtered(src, bsrc, b, bbody):
                if box_face_quadrature and bbody >= 0:
                    pair_bs.append((bi, si, *_series_gradient(
                        bprops, bell, props, ell)))
                else:
                    pair_sb.append((si, bi, *_combine(props, ell, bprops,
                                                      bell, r)))
        for wi, (wp, wr, wprops, wsrc) in enumerate(wspheres):
            if not filtered(src, wsrc, b, -1):
                r_eff = r * wr / (r + wr)
                pair_sw.append((si, wi, *_combine(props, ell, wprops, wr,
                                                  r_eff)))
    for si in range(len(spheres)):
        for sj in range(si + 1, len(spheres)):
            bi, bj = spheres[si][0], spheres[sj][0]
            if bi == bj or filtered(spheres[si][4], spheres[sj][4], bi, bj):
                continue
            ra, rb = spheres[si][2], spheres[sj][2]
            r_eff = ra * rb / (ra + rb)   # Hertz effective radius
            pair_ss.append((si, sj, *_combine(
                spheres[si][3], spheres[si][5],
                spheres[sj][3], spheres[sj][5], r_eff)))
    for bi, (bbody, R, p, half, bprops, bsrc, bell) in enumerate(boxes):
        if bbody < 0:
            continue
        for hi, (n, o, hprops, hsrc, hell) in enumerate(halfspaces):
            if not filtered(bsrc, hsrc, bbody, -1):
                pair_bh.append((bi, hi, *_series_gradient(
                    bprops, bell, hprops, hell)))

    if not (pair_sh or pair_sb or pair_ss or pair_sw or pair_bh or pair_bs):
        return None

    def arr(x, shape0=(0,)):
        a = np.asarray(x, float)
        if a.size == 0:
            a = np.zeros(shape0)
        return torch.as_tensor(a, dtype=dtype, device=dev)

    col = lambda pairs, k: [p[k] for p in pairs]
    return ContactModel(
        sph_body=tuple(s[0] for s in spheres),
        sph_offset=arr([s[1] for s in spheres], (0, 3)),
        sph_radius=arr([s[2] for s in spheres]),
        hs_normal=arr([h[0] for h in halfspaces], (0, 3)),
        hs_offset=arr([h[1] for h in halfspaces]),
        box_body=tuple(b[0] for b in boxes),
        box_rot=arr([b[1] for b in boxes], (0, 3, 3)),
        box_pos=arr([b[2] for b in boxes], (0, 3)),
        box_half=arr([b[3] for b in boxes], (0, 3)),
        ws_pos=arr([w[0] for w in wspheres], (0, 3)),
        ws_radius=arr([w[1] for w in wspheres]),
        pair_sh_s=tuple(col(pair_sh, 0)), pair_sh_h=tuple(col(pair_sh, 1)),
        sh_K=arr(col(pair_sh, 2)), sh_d=arr(col(pair_sh, 3)),
        sh_mu=arr(col(pair_sh, 4)),
        pair_sb_s=tuple(col(pair_sb, 0)), pair_sb_b=tuple(col(pair_sb, 1)),
        sb_K=arr(col(pair_sb, 2)), sb_d=arr(col(pair_sb, 3)),
        sb_mu=arr(col(pair_sb, 4)),
        pair_ss_a=tuple(col(pair_ss, 0)), pair_ss_b=tuple(col(pair_ss, 1)),
        ss_K=arr(col(pair_ss, 2)), ss_d=arr(col(pair_ss, 3)),
        ss_mu=arr(col(pair_ss, 4)),
        pair_sw_s=tuple(col(pair_sw, 0)), pair_sw_w=tuple(col(pair_sw, 1)),
        sw_K=arr(col(pair_sw, 2)), sw_d=arr(col(pair_sw, 3)),
        sw_mu=arr(col(pair_sw, 4)),
        pair_bh_b=tuple(col(pair_bh, 0)), pair_bh_h=tuple(col(pair_bh, 1)),
        bh_g=arr(col(pair_bh, 2)), bh_d=arr(col(pair_bh, 3)),
        bh_mu=arr(col(pair_bh, 4)),
        pair_bs_b=tuple(col(pair_bs, 0)), pair_bs_s=tuple(col(pair_bs, 1)),
        bs_g=arr(col(pair_bs, 2)), bs_d=arr(col(pair_bs, 3)),
        bs_mu=arr(col(pair_bs, 4)),
    )
