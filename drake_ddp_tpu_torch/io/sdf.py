"""SDF (Simulation Description Format) parser -> the URDF records.

Port of ``drake_ddp_tpu/io/sdf.py``.  Drake's classic models live in SDF
files (the cart-pole's ``cart_pole.sdf``; the port's copy is
``drake_ddp_tpu_torch/models/cart_pole.sdf``).  This parser covers the
subset those models use — links with model-frame poses, inertials,
sphere/box/cylinder/capsule collisions, revolute/prismatic/fixed joints
(including ``<parent>world</parent>``) — and lowers everything into the
same host-side IR as :mod:`io.urdf` (``UrdfRobot``), so ``add_urdf``
assembles both formats identically.

SDF frame semantics differ from URDF and are re-expressed here:

- a ``<link><pose>`` is relative to the MODEL frame (URDF has no link
  poses — child frames coincide with joint frames);
- a ``<joint><pose>`` is relative to the CHILD link frame (SDF <= 1.6);
- ``<axis><xyz>`` is expressed in the joint frame, or in the model frame
  when ``<use_parent_model_frame>`` is set (SDF <= 1.6 quirk);
- inertials and collisions are link-frame.

The lowering picks each body's canonical frame to be its JOINT frame
(the ModelBuilder convention, multibody/model.py docstring) and
re-expresses link-frame data there: X_PJ = X_MJ(parent)^-1 X_MJ(child)
with X_MJ = X_ML X_LJ.

Drake's actuation rule is mirrored: a revolute/prismatic joint gets an
actuator unless its ``<limit><effort>`` is exactly 0 (Drake's SDF parser
rule — cart_pole.sdf actuates the slider, the pole pin has effort 0).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from drake_ddp_tpu_torch.contact.geometry import ContactProps
from drake_ddp_tpu_torch.io.urdf import (
    UrdfCollision,
    UrdfJoint,
    UrdfLink,
    UrdfRobot,
    _parse_collision,
    _preprocess,
)

_SDF_JOINTS = ("revolute", "prismatic", "fixed", "continuous")


def _pose_of(el: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    """<pose>x y z roll pitch yaw</pose> -> (pos (3,), rot (3,3))."""
    if el is None or not (el.text or "").strip():
        return np.zeros(3), np.eye(3)
    vals = [float(v) for v in el.text.split()]
    pos = np.asarray(vals[:3], float)
    r, p, y = (vals[3:6] + [0.0, 0.0, 0.0])[:3] if len(vals) > 3 else (0, 0, 0)
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return pos, Rz @ Ry @ Rx


def _compose(pa, Ra, pb, Rb):
    """X_a * X_b -> (p, R)."""
    return pa + Ra @ pb, Ra @ Rb


def _invert(p, R):
    return -R.T @ p, R.T


def _parse_inertial(el: Optional[ET.Element]):
    """-> (mass, com (3,) link frame, inertia (3,3) about com, link frame)."""
    if el is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(el.findtext("mass", "0"))
    p_LI, R_LI = _pose_of(el.find("pose"))
    ine = el.find("inertia")
    if ine is None:
        I_I = np.zeros((3, 3))
    else:
        g = lambda k: float(ine.findtext(k, "0"))
        I_I = np.array([
            [g("ixx"), g("ixy"), g("ixz")],
            [g("ixy"), g("iyy"), g("iyz")],
            [g("ixz"), g("iyz"), g("izz")],
        ])
    return mass, p_LI, R_LI @ I_I @ R_LI.T


def _parse_sdf_collision(el: ET.Element) -> Optional[UrdfCollision]:
    """SDF <collision>: same <geometry> children as URDF but sized with
    full text elements; reuse the URDF geometry reader by rewriting."""
    geom = el.find("geometry")
    if geom is None:
        return None
    # rewrite SDF's child-element sizes into URDF's attribute style, then
    # delegate (keeps one geometry table)
    for kind, attrs in (("sphere", ("radius",)), ("box", ("size",)),
                        ("cylinder", ("radius", "length")),
                        ("capsule", ("radius", "length"))):
        g = geom.find(kind)
        if g is not None:
            for a in attrs:
                val = g.findtext(a)
                if val is not None:
                    g.set(a, val.strip())
    pos, rot = _pose_of(el.find("pose"))
    col = _parse_collision(el)
    if col is not None:
        col.pos, col.rot = pos, rot
    return col


def parse_sdf(path_or_text: str, base_dir: Optional[str] = None,
              props: ContactProps = ContactProps()) -> UrdfRobot:
    """Parse an SDF file path (or raw XML) into the shared URDF IR."""
    if "<sdf" in path_or_text or "<model" in path_or_text:
        text = path_or_text
        base = base_dir or "."
    else:
        with open(path_or_text) as f:
            text = f.read()
        base = base_dir or os.path.dirname(os.path.abspath(path_or_text))
    root_el = ET.fromstring(_preprocess(text))
    model = root_el.find("model") if root_el.tag != "model" else root_el
    if model is None:
        raise ValueError("no <model> element in SDF")

    # --- gather link data in the MODEL frame -------------------------
    link_pose: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    link_raw: Dict[str, dict] = {}
    for le in model.findall("link"):
        name = le.get("name")
        link_pose[name] = _pose_of(le.find("pose"))
        mass, com_L, I_L = _parse_inertial(le.find("inertial"))
        cols = [c for c in map(_parse_sdf_collision, le.findall("collision"))
                if c is not None]
        link_raw[name] = dict(mass=mass, com=com_L, inertia=I_L, cols=cols)

    joints_el = [j for j in model.findall("joint")
                 if j.get("type") in _SDF_JOINTS]
    child_of = {j.findtext("child").strip(): j for j in joints_el}

    # joint frame of each link: X_MJ = X_ML * X_LJ (root: link frame)
    frame: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name in link_raw:
        p_ML, R_ML = link_pose[name]
        je = child_of.get(name)
        if je is not None:
            p_LJ, R_LJ = _pose_of(je.find("pose"))
            frame[name] = _compose(p_ML, R_ML, p_LJ, R_LJ)
        else:
            frame[name] = (p_ML, R_ML)

    # --- lower links into their joint frames --------------------------
    links: Dict[str, UrdfLink] = {}
    for name, raw in link_raw.items():
        p_ML, R_ML = link_pose[name]
        p_MJ, R_MJ = frame[name]
        p_JL, R_JL = _compose(*_invert(p_MJ, R_MJ), p_ML, R_ML)
        com = p_JL + R_JL @ raw["com"]
        inertia = R_JL @ raw["inertia"] @ R_JL.T
        cols = []
        for c in raw["cols"]:
            cp, cR = _compose(p_JL, R_JL, c.pos, c.rot)
            cols.append(UrdfCollision(c.kind, cp, cR, c.size, c.mesh_file,
                                      c.props if c.props else props,
                                      c.mesh_scale))
        links[name] = UrdfLink(name, raw["mass"], com, inertia, cols)

    # --- joints --------------------------------------------------------
    joints: List[UrdfJoint] = []
    for je in joints_el:
        jname = je.get("name")
        jtype = je.get("type")
        parent = je.findtext("parent").strip()
        child = je.findtext("child").strip()
        p_MJ, R_MJ = frame[child]
        if parent == "world":
            p_PJ, R_PJ = p_MJ, R_MJ
        else:
            p_PJ, R_PJ = _compose(*_invert(*frame[parent]), p_MJ, R_MJ)
        ax_el = je.find("axis")
        axis = np.array([0.0, 0.0, 1.0])
        damping = 0.0
        effort = -1.0  # SDF default: unlimited -> Drake adds an actuator
        if ax_el is not None:
            xyz = ax_el.findtext("xyz")
            if xyz:
                axis = np.asarray([float(v) for v in xyz.split()], float)
            if (ax_el.findtext("use_parent_model_frame", "0").strip()
                    in ("1", "true")):
                axis = R_MJ.T @ axis
            dyn = ax_el.find("dynamics")
            if dyn is not None:
                damping = float(dyn.findtext("damping", "0"))
            lim = ax_el.find("limit")
            if lim is not None:
                effort = float(lim.findtext("effort", "-1"))
        actuated = jtype in ("revolute", "prismatic", "continuous") and \
            effort != 0.0
        joints.append(UrdfJoint(jname, jtype, parent, child,
                                p_PJ, R_PJ, axis, damping=damping,
                                actuated=actuated))

    # root: link that is nobody's child, or None when the tree hangs off
    # an explicit world joint (add_urdf seeds body_index["world"])
    children = set(child_of)
    roots = [n for n in link_raw if n not in children]
    root = roots[0] if roots else None
    if root is None and not any(j.parent == "world" for j in joints):
        raise ValueError("SDF model has no root link and no world joint")

    return UrdfRobot(model.get("name", "sdf_model"), links, joints,
                     root, [], base)


def add_sdf(builder, geometry, robot, **kwargs):
    """``add_urdf`` for SDF input (path, XML text, or parsed UrdfRobot)."""
    from drake_ddp_tpu_torch.io.urdf import add_urdf

    if isinstance(robot, str):
        robot = parse_sdf(robot)
    return add_urdf(builder, geometry, robot, **kwargs)
