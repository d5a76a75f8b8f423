"""Robot description records -> multibody model + contact scene.

Port of the part of ``drake_ddp_tpu/io/urdf.py`` this slice uses: the
``Urdf*`` host records and :func:`add_urdf`, which feeds a
:class:`~drake_ddp_tpu_torch.multibody.model.ModelBuilder` and a
:class:`~drake_ddp_tpu_torch.contact.geometry.GeometrySet`.  Sphere,
box, cylinder and capsule collisions are supported; mesh collisions
(bounding-sphere covers) and the XML parser come with the manipulation
slice (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from drake_ddp_tpu_torch.contact.geometry import (
    CollisionGeometry,
    ContactProps,
    GeometrySet,
)
from drake_ddp_tpu_torch.multibody.model import (
    FIXED,
    FREE,
    PRISMATIC,
    REVOLUTE,
    ModelBuilder,
)

_JOINT_TYPES = {
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "fixed": FIXED,
    "floating": FREE,
}


@dataclasses.dataclass
class UrdfCollision:
    kind: str                 # sphere | box | cylinder | capsule | mesh
    pos: np.ndarray           # link frame
    rot: np.ndarray
    size: np.ndarray          # sphere [r]; box half-extents; cyl [r, hl]
    mesh_file: Optional[str]  # relative path for kind == mesh
    props: ContactProps
    mesh_scale: float = 1.0


@dataclasses.dataclass
class UrdfLink:
    name: str
    mass: float
    com: np.ndarray
    inertia: np.ndarray       # (3,3) about com, link frame
    collisions: List[UrdfCollision]


@dataclasses.dataclass
class UrdfJoint:
    name: str
    type: str
    parent: str
    child: str
    origin_pos: np.ndarray
    origin_rot: np.ndarray
    axis: np.ndarray
    damping: float = 0.0
    actuated: bool = False
    armature: float = 0.0     # gear_ratio^2 * rotor_inertia


@dataclasses.dataclass
class UrdfRobot:
    name: str
    links: Dict[str, UrdfLink]
    joints: List[UrdfJoint]
    root: Optional[str]       # None: every link hangs off "world" joints
    filtered_link_pairs: List[Tuple[str, str]]
    dir: str


def add_urdf(
    builder: ModelBuilder,
    geometry: Optional[GeometrySet],
    robot: UrdfRobot,
    *,
    base_parent: int = -1,
    base_pos: Sequence[float] = (0.0, 0.0, 0.0),
    base_rot: Optional[np.ndarray] = None,
    floating: bool = True,
    prefix: str = "",
) -> Dict[str, int]:
    """Add a robot record to a ModelBuilder (+ GeometrySet).

    ``base_parent`` / ``base_pos`` / ``base_rot`` place the root link
    relative to an existing body (-1 = world); ``floating=True`` gives
    the root a free (quaternion) joint, ``False`` welds it.  Joints are
    added in document order (Drake's q/v slot order).  Returns
    {link_name: body_index}."""
    if not isinstance(robot, UrdfRobot):
        raise NotImplementedError(
            "URDF text parsing is not ported yet (ROADMAP Queue 1, item "
            "10); pass a UrdfRobot record, e.g. models.mini_cheetah()")
    base_rot = np.eye(3) if base_rot is None else np.asarray(base_rot)
    base_pos = np.asarray(base_pos, np.float64)
    body_index: Dict[str, int] = {}

    def add_link(link_name, parent_idx, jtype, X_pos, X_rot, axis,
                 damping, armature, actuated) -> int:
        link = robot.links[link_name]
        idx = builder.add_body(
            prefix + link_name, parent_idx, jtype,
            X_PJ_rot=X_rot, X_PJ_pos=X_pos, axis=axis, mass=link.mass,
            com=link.com, inertia=link.inertia, damping=damping,
            armature=armature, actuated=actuated)
        body_index[link_name] = idx
        if geometry is not None:
            for c in link.collisions:
                _add_collision(geometry, idx, c)
        return idx

    if robot.root is not None:
        add_link(robot.root, base_parent, FREE if floating else FIXED,
                 base_pos, base_rot, np.array([0.0, 0.0, 1.0]), 0.0, 0.0,
                 False)
    else:
        body_index["world"] = base_parent

    pending = list(robot.joints)
    while pending:
        progressed = False
        remaining = []
        for j in pending:
            if j.parent in body_index:
                o_pos, o_rot = j.origin_pos, j.origin_rot
                if j.parent == "world" and robot.root is None:
                    o_pos = base_pos + base_rot @ np.asarray(o_pos)
                    o_rot = base_rot @ np.asarray(o_rot)
                add_link(j.child, body_index[j.parent], _JOINT_TYPES[j.type],
                         o_pos, o_rot, j.axis, j.damping, j.armature,
                         j.actuated)
                progressed = True
            else:
                remaining.append(j)
        if not progressed:
            raise ValueError(
                "unreachable joints (parent links missing): "
                f"{[j.name for j in remaining]}")
        pending = remaining

    if geometry is not None:
        for la, lb in robot.filtered_link_pairs:
            if la in body_index and lb in body_index:
                geometry.exclude_body_pair(body_index[la], body_index[lb])
        # Drake filters collisions between bodies joined by a joint
        for j in robot.joints:
            if j.parent in body_index:
                geometry.exclude_body_pair(body_index[j.parent],
                                           body_index[j.child])
    return body_index


def _add_collision(gs: GeometrySet, body: int, c: UrdfCollision):
    if c.kind == "mesh":
        raise NotImplementedError(
            f"mesh collision {c.mesh_file!r}: bounding-sphere mesh covers "
            "come with the manipulation slice (ROADMAP Queue 1, item 10)")
    gs.add(CollisionGeometry(body, c.kind, c.pos, c.rot, c.size, c.props))
