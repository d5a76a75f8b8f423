"""Multibody model description: a static kinematic tree + numeric tables.

Port of ``drake_ddp_tpu/multibody/model.py``.  Topology (parents, joint
types, index layouts) is static Python data; inertial and geometric
numbers are float32 torch tensors on the model's device.

Conventions (as the JAX package, matching Drake):
- bodies are topologically sorted (parent index < child index), body 0's
  parent is the world (-1);
- a floating body's q is [qw qx qy qz, px py pz], its v is [wx wy wz,
  vx vy vz] (world-frame angular, then world-frame translational
  velocity of the body origin); 1-dof joints contribute one q and one v;
- URDF child-link frames coincide with their joint frames.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device

# Joint type codes (static)
FREE = 0
REVOLUTE = 1
PRISMATIC = 2
FIXED = 3

_NQ = {FREE: 7, REVOLUTE: 1, PRISMATIC: 1, FIXED: 0}
_NV = {FREE: 6, REVOLUTE: 1, PRISMATIC: 1, FIXED: 0}

_MODEL_TENSORS = ("X_PJ_rot", "X_PJ_pos", "axis", "mass", "com", "inertia",
                  "damping", "armature", "gravity")


@dataclasses.dataclass(frozen=True)
class MultibodyModel:
    """A rigid-body tree: static topology + float32 tensors."""

    # --- static topology ---
    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    q_start: Tuple[int, ...]
    v_start: Tuple[int, ...]
    nq: int
    nv: int
    nu: int
    actuated_vdof: Tuple[int, ...]   # v-dof driven by each input (len nu)
    body_names: Tuple[str, ...]

    # --- numeric tables (float32, on the model's device) ---
    X_PJ_rot: torch.Tensor  # (nb, 3, 3) joint frame rotation in parent
    X_PJ_pos: torch.Tensor  # (nb, 3)    joint frame origin in parent
    axis: torch.Tensor      # (nb, 3)    joint axis in child frame (unit)
    mass: torch.Tensor      # (nb,)
    com: torch.Tensor       # (nb, 3)    center of mass, body frame
    inertia: torch.Tensor   # (nb, 3, 3) rotational inertia about com
    damping: torch.Tensor   # (nv,)      viscous damping per v-dof
    armature: torch.Tensor  # (nv,)      reflected rotor inertia (M diag)
    gravity: torch.Tensor   # (3,)

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def default_q(self) -> np.ndarray:
        q = np.zeros(self.nq)
        for b, jt in enumerate(self.joint_type):
            if jt == FREE:
                q[self.q_start[b]] = 1.0  # identity quaternion (w first)
        return q

    def actuation_matrix(self) -> np.ndarray:
        """B (nv, nu): tau = B @ u."""
        B = np.zeros((self.nv, self.nu))
        for i, vd in enumerate(self.actuated_vdof):
            B[vd, i] = 1.0
        return B


class ModelBuilder:
    """Host-side incremental tree builder (the JAX package's ModelBuilder)."""

    def __init__(self, gravity=(0.0, 0.0, -9.81)):
        self._bodies = []
        self._gravity = np.asarray(gravity, np.float64)

    def add_body(
        self,
        name: str,
        parent: int,
        joint_type: int,
        X_PJ_rot=None,
        X_PJ_pos=None,
        axis=(0.0, 0.0, 1.0),
        mass: float = 0.0,
        com=(0.0, 0.0, 0.0),
        inertia=None,
        damping: float = 0.0,
        armature: float = 0.0,
        actuated: bool = False,
    ) -> int:
        """Add a body connected to ``parent`` (-1 = world); returns its
        index."""
        if parent >= len(self._bodies):
            raise ValueError(
                f"parent {parent} not yet added: bodies must come in "
                "topological order")
        self._bodies.append(dict(
            name=name,
            parent=parent,
            joint_type=joint_type,
            X_PJ_rot=(np.eye(3) if X_PJ_rot is None
                      else np.asarray(X_PJ_rot, np.float64)),
            X_PJ_pos=(np.zeros(3) if X_PJ_pos is None
                      else np.asarray(X_PJ_pos, np.float64)),
            axis=np.asarray(axis, np.float64),
            mass=float(mass),
            com=np.asarray(com, np.float64),
            inertia=(np.zeros((3, 3)) if inertia is None
                     else np.asarray(inertia, np.float64)),
            damping=float(damping),
            armature=float(armature),
            actuated=actuated,
        ))
        return len(self._bodies) - 1

    def finalize(self, dtype=torch.float32, device="cuda") -> MultibodyModel:
        dev = resolve_device(device)
        bodies = self._bodies
        q_start, v_start = [], []
        nq = nv = 0
        for b in bodies:
            q_start.append(nq)
            v_start.append(nv)
            nq += _NQ[b["joint_type"]]
            nv += _NV[b["joint_type"]]
        actuated_vdof = tuple(
            v_start[i] for i, b in enumerate(bodies)
            if b["actuated"] and _NV[b["joint_type"]] == 1)
        damping = np.zeros(nv)
        armature = np.zeros(nv)
        for i, b in enumerate(bodies):
            if _NV[b["joint_type"]] == 1:
                damping[v_start[i]] = b["damping"]
                armature[v_start[i]] = b["armature"]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        return MultibodyModel(
            parent=tuple(b["parent"] for b in bodies),
            joint_type=tuple(b["joint_type"] for b in bodies),
            q_start=tuple(q_start),
            v_start=tuple(v_start),
            nq=nq,
            nv=nv,
            nu=len(actuated_vdof),
            actuated_vdof=actuated_vdof,
            body_names=tuple(b["name"] for b in bodies),
            X_PJ_rot=t(np.stack([b["X_PJ_rot"] for b in bodies])),
            X_PJ_pos=t(np.stack([b["X_PJ_pos"] for b in bodies])),
            axis=t(np.stack([b["axis"] for b in bodies])),
            mass=t([b["mass"] for b in bodies]),
            com=t(np.stack([b["com"] for b in bodies])),
            inertia=t(np.stack([b["inertia"] for b in bodies])),
            damping=t(damping),
            armature=t(armature),
            gravity=t(self._gravity),
        )


def ancestor_dof_mask(model: MultibodyModel) -> np.ndarray:
    """(nb, nv) static 0/1 mask: mask[b, k] = 1 iff v-dof k is on the path
    from the world to body b."""
    mask = np.zeros((model.nb, model.nv))
    for b in range(model.nb):
        i = b
        while i >= 0:
            s, n = model.v_start[i], _NV[model.joint_type[i]]
            mask[b, s:s + n] = 1.0
            i = model.parent[i]
    return mask


def vdof_body(model: MultibodyModel) -> np.ndarray:
    """(nv,) body index owning each v-dof."""
    out = np.zeros(model.nv, np.int64)
    for b in range(model.nb):
        s, n = model.v_start[b], _NV[model.joint_type[b]]
        out[s:s + n] = b
    return out


def from_numpy(model_arrays: Dict, contact_arrays: Dict | None,
               device="cuda"):
    """The port's (MultibodyModel, ContactModel) from the JAX package's
    ``MultibodyModel`` and ``ContactModel`` fields, given as dicts of
    numpy arrays, ints and int tuples (e.g. ``{f.name: np.asarray(v)}``
    over the dataclass / NamedTuple fields).

    Lets the same constants drive both packages; arrays are stored as
    float32 tensors on ``device``.  ``contact_arrays`` None (a scene with
    no contact candidates) returns contact None."""
    from drake_ddp_tpu_torch.contact.geometry import ContactModel

    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    ints = lambda a: tuple(int(i) for i in np.asarray(a).reshape(-1))
    static_model = ("parent", "joint_type", "q_start", "v_start",
                    "actuated_vdof")
    model = MultibodyModel(
        **{k: ints(model_arrays[k]) for k in static_model},
        nq=int(model_arrays["nq"]),
        nv=int(model_arrays["nv"]),
        nu=int(model_arrays["nu"]),
        body_names=tuple(str(s) for s in model_arrays["body_names"]),
        **{k: f32(model_arrays[k]) for k in _MODEL_TENSORS},
    )
    if contact_arrays is None:
        return model, None
    fields = {}
    for k in ContactModel._fields:
        v = contact_arrays.get(k)
        if k.startswith("pair_") or k in ("sph_body", "box_body"):
            fields[k] = ints(() if v is None else v)
        else:
            fields[k] = f32(np.zeros(0) if v is None else v)
    return model, ContactModel(**fields)
