"""The packed model + contact + solver table the CUDA device step reads.

:class:`StepTable` mirrors ``struct StepTable`` of ``csrc/lanestep.cuh``
field for field (ints first, then floats, all 4 bytes, so neither side
pads).  :class:`StepKernelData` builds it from a model, a contact scene
and the step's options, with every float constant taken from the plain
step's own float32 :class:`~drake_ddp_tpu_torch.multibody.lanestep.
LaneConsts`, so the kernel and the plain version run on identical
numbers.  It also carries that plain step and the plain lane Jacobians,
which the kernel wrappers run for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from drake_ddp_tpu_torch.contact.forces import (ContactForceParams,
                                                stiction_schedule)
from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac
from drake_ddp_tpu_torch.multibody.lanestep import (LaneConsts,
                                                    make_lane_step)
from drake_ddp_tpu_torch.multibody.model import MultibodyModel, vdof_body

MAX_BODIES, MAX_Q, MAX_V, MAX_U = 32, 40, 32, 32
MAX_CONTACTS, MAX_SPHERES, MAX_BOXES, MAX_HALFSPACES = 64, 32, 8, 4
MAX_ITERS = 16
C_SH, C_SB, C_BH = 0, 1, 2

_i32, _f32 = ctypes.c_int32, ctypes.c_float


class StepTable(ctypes.Structure):
    _fields_ = [(k, _i32) for k in ("nb", "nq", "nv", "nu", "nc", "ns",
                                    "nbox", "nh", "contact_iters",
                                    "has_contact", "nlevels")] + [
        ("parent", _i32 * MAX_BODIES),
        ("jtype", _i32 * MAX_BODIES),
        ("q_start", _i32 * MAX_BODIES),
        ("v_start", _i32 * MAX_BODIES),
        ("level_start", _i32 * (MAX_BODIES + 1)),
        ("level_body", _i32 * MAX_BODIES),
        ("act_vdof", _i32 * MAX_U),
        ("dof_parent", _i32 * MAX_V),
        ("sph_body", _i32 * MAX_SPHERES),
        ("box_body", _i32 * MAX_BOXES),
        ("c_kind", _i32 * MAX_CONTACTS),
        ("c_i0", _i32 * MAX_CONTACTS),
        ("c_i1", _i32 * MAX_CONTACTS),
        ("c_corner", _i32 * MAX_CONTACTS),
        ("c_body_a", _i32 * MAX_CONTACTS),
        ("c_body_b", _i32 * MAX_CONTACTS),
        ("dt", _f32), ("smooth_width", _f32), ("stiction_vel", _f32),
        ("force_scale", _f32),
        ("sched", _f32 * MAX_ITERS),
        ("X_rot", _f32 * 9 * MAX_BODIES),
        ("X_pos", _f32 * 3 * MAX_BODIES),
        ("axis", _f32 * 3 * MAX_BODIES),
        ("rot_K", _f32 * 9 * MAX_BODIES),
        ("rot_K2", _f32 * 9 * MAX_BODIES),
        ("mass", _f32 * MAX_BODIES),
        ("com", _f32 * 3 * MAX_BODIES),
        ("inertia", _f32 * 9 * MAX_BODIES),
        ("damping", _f32 * MAX_V),
        ("armature", _f32 * MAX_V),
        ("gravity", _f32 * 3),
        ("is_ang", _f32 * MAX_V),
        ("is_lin", _f32 * MAX_V),
        ("anc", _f32 * MAX_V * MAX_BODIES),
        ("sph_off", _f32 * 3 * MAX_SPHERES),
        ("sph_r", _f32 * MAX_SPHERES),
        ("hs_n", _f32 * 3 * MAX_HALFSPACES),
        ("hs_off", _f32 * MAX_HALFSPACES),
        ("box_rot", _f32 * 9 * MAX_BOXES),
        ("box_pos", _f32 * 3 * MAX_BOXES),
        ("box_half", _f32 * 3 * MAX_BOXES),
        ("c_K", _f32 * MAX_CONTACTS),
        ("c_d", _f32 * MAX_CONTACTS),
        ("c_mu", _f32 * MAX_CONTACTS),
        ("c_g", _f32 * MAX_CONTACTS),
    ]


def _fill(field, values):
    """Write a flat sequence into a (possibly nested) ctypes array."""
    flat = np.asarray(values).reshape(-1)
    arr = field
    if flat.size and isinstance(arr[0], ctypes.Array):
        inner = len(arr[0])
        for i in range(flat.size // inner):
            for j in range(inner):
                arr[i][j] = flat[i * inner + j].item()
    else:
        for i, v in enumerate(flat):
            arr[i] = v.item()


def _check(name, count, limit):
    if count > limit:
        raise ValueError(f"{name} = {count} exceeds the CUDA step's table "
                         f"limit {limit} (csrc/lanestep.cuh)")


def tree_levels(parent):
    """The bodies by depth in the kinematic tree (parents first): those of
    depth d are ``bodies[starts[d]:starts[d + 1]]``.  The device step
    runs the bodies of one depth in parallel."""
    depth = []
    for b, p in enumerate(parent):
        depth.append(0 if p < 0 else depth[p] + 1)
    bodies = sorted(range(len(parent)), key=lambda b: (depth[b], b))
    counts = np.bincount(depth, minlength=max(depth, default=-1) + 1)
    return [0] + np.cumsum(counts).tolist(), bodies


def pack_step_table(model: MultibodyModel, contact: Optional[ContactModel],
                    dt: float, contact_iters: int,
                    force_params: ContactForceParams) -> StepTable:
    """The filled table for one (model, contact scene, step options)."""
    C = LaneConsts(model, contact, torch.float32)
    f = lambda a: a.detach().cpu().numpy()
    has_contact = C.has_contact
    _check("bodies", model.nb, MAX_BODIES)
    _check("nq", model.nq, MAX_Q)
    _check("nv", model.nv, MAX_V)
    _check("nu", model.nu, MAX_U)
    _check("contact_iters", contact_iters, MAX_ITERS)
    T = StepTable()
    T.nb, T.nq, T.nv, T.nu = model.nb, model.nq, model.nv, model.nu
    T.contact_iters = contact_iters
    T.has_contact = int(has_contact)
    for name, vals in (("parent", model.parent), ("jtype", model.joint_type),
                       ("q_start", model.q_start), ("v_start", model.v_start),
                       ("act_vdof", model.actuated_vdof)):
        _fill(getattr(T, name), np.asarray(vals, np.int32))
    starts, bodies = tree_levels(model.parent)
    T.nlevels = len(starts) - 1
    _fill(T.level_start, np.asarray(starts, np.int32))
    _fill(T.level_body, np.asarray(bodies, np.int32))
    dof_body = vdof_body(model)
    _fill(T.dof_parent, np.asarray([model.parent[b] for b in dof_body],
                                   np.int32))
    T.dt, T.smooth_width = dt, force_params.smooth_width
    T.stiction_vel, T.force_scale = (force_params.stiction_vel,
                                     force_params.force_scale)
    _fill(T.sched, np.asarray(
        stiction_schedule(force_params.stiction_vel, contact_iters),
        np.float32))
    for name, val in (("X_rot", C.X_rot), ("X_pos", C.X_pos),
                      ("axis", C.axis), ("rot_K", C.rot_K),
                      ("rot_K2", C.rot_K2), ("mass", C.mass), ("com", C.com),
                      ("inertia", C.inertia), ("damping", C.damping),
                      ("armature", torch.diagonal(C.armature_diag)),
                      ("gravity", C.gravity), ("is_ang", C.is_ang),
                      ("is_lin", C.is_lin)):
        _fill(getattr(T, name), f(val))
    anc = np.zeros((MAX_BODIES, MAX_V), np.float32)
    anc[:model.nb, :model.nv] = f(C.anc)
    _fill(T.anc, anc)
    if has_contact:
        _pack_contact(T, contact, C, f)
    return T


def _pack_contact(T: StepTable, cm: ContactModel, C: LaneConsts, f):
    if cm.pair_ss_a or cm.pair_sw_s or cm.pair_bs_b:
        raise NotImplementedError(
            "the CUDA step covers the sphere-halfspace, sphere-box and "
            "box-face-halfspace families; sphere-sphere, world-sphere and "
            "box-face-sphere pairs come with the manipulation slice")
    ns, nbox, nh = len(cm.sph_body), len(cm.box_body), len(cm.hs_offset)
    _check("spheres", ns, MAX_SPHERES)
    _check("boxes", nbox, MAX_BOXES)
    _check("halfspaces", nh, MAX_HALFSPACES)
    _check("contacts", cm.num_contacts, MAX_CONTACTS)
    T.nc, T.ns, T.nbox, T.nh = cm.num_contacts, ns, nbox, nh
    _fill(T.sph_body, np.asarray(cm.sph_body, np.int32))
    _fill(T.box_body, np.asarray(cm.box_body, np.int32))
    for name, val in (("sph_off", C.sph_offset), ("sph_r", C.sph_radius),
                      ("hs_n", C.hs_normal), ("hs_off", C.hs_offset),
                      ("box_rot", C.box_rot), ("box_pos", C.box_pos),
                      ("box_half", C.box_half)):
        _fill(getattr(T, name), f(val))
    # contact rows in the narrowphase's order: sh, sb, then 8 bh corners
    kind, i0, i1, corner, g = [], [], [], [], []
    for si, hi in zip(cm.pair_sh_s, cm.pair_sh_h):
        kind.append(C_SH); i0.append(si); i1.append(hi)
        corner.append(0); g.append(0.0)
    for si, bi in zip(cm.pair_sb_s, cm.pair_sb_b):
        kind.append(C_SB); i0.append(si); i1.append(bi)
        corner.append(0); g.append(0.0)
    bh_g = f(C.bh_g)
    for pi, (bi, hi) in enumerate(zip(cm.pair_bh_b, cm.pair_bh_h)):
        for k in range(8):
            kind.append(C_BH); i0.append(bi); i1.append(hi)
            corner.append(k); g.append(bh_g[pi])
    for name, vals in (("c_kind", kind), ("c_i0", i0), ("c_i1", i1),
                       ("c_corner", corner), ("c_body_a", C.body_a),
                       ("c_body_b", C.body_b)):
        _fill(getattr(T, name), np.asarray(vals, np.int32))
    _fill(T.c_K, f(C.K))
    _fill(T.c_d, f(C.d))
    _fill(T.c_mu, f(C.mu))
    _fill(T.c_g, np.asarray(g, np.float32))


class StepKernelData:
    """One step's CUDA table and its plain PyTorch versions.

    ``step`` is the plain lane step and :meth:`lane_jac` the plain lane
    Jacobian (the wrappers' CPU path and the kernels' references);
    :meth:`table` is the packed table as a uint8 tensor on a CUDA device
    (built once per device)."""

    def __init__(self, model: MultibodyModel,
                 contact: Optional[ContactModel], dt: float,
                 contact_iters: int = 2,
                 force_params: ContactForceParams = ContactForceParams(),
                 step=None):
        self.model, self.contact = model, contact
        self.n, self.m = model.nq + model.nv, model.nu
        self.dt, self.contact_iters = dt, contact_iters
        self.force_params = force_params
        self.step = step if step is not None else make_lane_step(
            model, contact, dt, contact_iters=contact_iters,
            force_params=force_params)
        self._struct = pack_step_table(model, contact, dt, contact_iters,
                                       force_params)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        self._jacs: Dict[bool, object] = {}

    def lane_jac(self, root_seed: bool):
        """The plain lane Jacobian of this step (``make_lane_jac``), root-
        seeded ``(x, u, x_next)`` or cold ``(x, u)``; built once."""
        if root_seed not in self._jacs:
            self._jacs[root_seed] = make_lane_jac(
                self.model, self.contact, self.dt,
                contact_iters=self.contact_iters,
                force_params=self.force_params, root_seed=root_seed)
        return self._jacs[root_seed]

    @property
    def sizes(self):
        """(nb, nq, nv, nu, nc, ns, nbox) for the working-set layout."""
        s = self._struct
        return (s.nb, s.nq, s.nv, s.nu, s.nc, s.ns, s.nbox)

    def table(self, device: torch.device, lib) -> torch.Tensor:
        if ctypes.sizeof(StepTable) != lib.ddp_table_bytes():
            raise RuntimeError(
                f"StepTable is {ctypes.sizeof(StepTable)} bytes in Python "
                f"but {lib.ddp_table_bytes()} in csrc/lanestep.cuh")
        if device not in self._tables:
            raw = bytearray(bytes(self._struct))
            self._tables[device] = torch.frombuffer(
                raw, dtype=torch.uint8).to(device)
        return self._tables[device]


def kernel_data_for_system(system) -> StepKernelData:
    """The kernel data of a multibody DiscreteSystem built by
    :func:`drake_ddp_tpu_torch.multibody.plant.make_multibody_system`
    (which records the step's build options on its lane step).  Built
    once and kept on that lane step, so every solve of the system shares
    one packed table per device."""
    lane = system.lane_step_fn
    kd = getattr(lane, "kernel_data", None)
    if kd is None:
        model, contact = system.params
        kd = lane.kernel_data = StepKernelData(
            model, contact, system.dt, contact_iters=lane.contact_iters,
            force_params=lane.force_params, step=lane)
    return kd
