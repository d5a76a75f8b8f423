"""The reference's model of a configuration: the robot from its frozen
data file (``robots/<name>.json``, the numbers of the port's embedded
model data), the ball and the ground the configuration adds, and the
plain step and step Jacobian built on them (frozen copies of the port's
plain PyTorch versions, beside this file).

What the program builds from its own files, this builds again from these
and from the configuration's file, so a change to the program's model,
contact scene or step shows as a gap between the two.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from portbench.reference.forces import ContactForceParams
from portbench.reference.geometry import (HALFSPACE, SPHERE,
                                          CollisionGeometry, ContactProps,
                                          GeometrySet, build_contact_model)
from portbench.reference.lanejac import make_lane_jac
from portbench.reference.lanestep import make_lane_step
from portbench.reference.model import FIXED, FREE, PRISMATIC, REVOLUTE
from portbench.reference.model import ModelBuilder

ROBOTS = Path(__file__).resolve().parent / "robots"
_JOINT_TYPES = {"revolute": REVOLUTE, "continuous": REVOLUTE,
                "prismatic": PRISMATIC, "fixed": FIXED, "floating": FREE}


def _props(d: Dict) -> ContactProps:
    return ContactProps(
        modulus=np.inf if d["modulus"] is None else d["modulus"],
        dissipation=d["dissipation"], mu_static=d["mu_static"],
        mu_dynamic=d["mu_dynamic"], resolution_hint=d["resolution_hint"])


def add_robot(mb: ModelBuilder, gs: GeometrySet, data: Dict,
              floating: bool, base_pos) -> Dict[str, int]:
    """Add a robot's links in joint order (the slot order of its q and
    v), its collision geometries and its collision filters: the port's
    ``add_urdf`` on a data record with no meshes."""
    index: Dict[str, int] = {}

    def add_link(name, parent, jtype, pos, rot, axis, damping, armature,
                 actuated):
        link = data["links"][name]
        idx = mb.add_body(name, parent, jtype, X_PJ_rot=np.asarray(rot),
                          X_PJ_pos=np.asarray(pos, np.float64),
                          axis=np.asarray(axis), mass=link["mass"],
                          com=np.asarray(link["com"]),
                          inertia=np.asarray(link["inertia"]),
                          damping=damping, armature=armature,
                          actuated=actuated)
        index[name] = idx
        for c in data["collisions"]:
            if c["link"] == name:
                gs.add(CollisionGeometry(idx, c["kind"], np.asarray(c["pos"]),
                                         np.asarray(c["rot"]),
                                         np.asarray(c["size"]),
                                         _props(c["props"])))
        return idx

    add_link(data["root"], -1, FREE if floating else FIXED, base_pos,
             np.eye(3), [0.0, 0.0, 1.0], 0.0, 0.0, False)
    pending = list(data["joints"])
    while pending:
        rest = []
        for j in pending:
            if j["parent"] in index:
                add_link(j["child"], index[j["parent"]],
                         _JOINT_TYPES[j["type"]], j["origin_pos"],
                         j["origin_rot"], j["axis"], j["damping"],
                         j["armature"], j["actuated"])
            else:
                rest.append(j)
        if len(rest) == len(pending):
            raise ValueError("unreachable joints in the robot data")
        pending = rest
    for la, lb in data["filtered_link_pairs"]:
        if la in index and lb in index:
            gs.exclude_body_pair(index[la], index[lb])
    for j in data["joints"]:
        gs.exclude_body_pair(index[j["parent"]], index[j["child"]])
    return index


def build(model_cfg: Dict, device, dtype_tables=None):
    """(model, contact, lane step, cold lane Jacobian, root-seeded lane
    Jacobian) of a configuration's ``model`` block, on ``device``."""
    import torch
    data = json.loads((ROBOTS / f"{model_cfg['robot']}.json").read_text())
    mb, gs = ModelBuilder(), GeometrySet()
    add_robot(mb, gs, data, model_cfg["floating"], model_cfg["base_pos"])
    ball = model_cfg.get("ball")
    if ball is not None:
        r, mass = ball["radius"], ball["mass"]
        idx = mb.add_body("ball", -1, FREE, mass=mass,
                          inertia=(2.0 / 3.0) * mass * r * r * np.eye(3))
        gs.add(CollisionGeometry(idx, SPHERE, np.zeros(3), np.eye(3),
                                 np.array([r]), ContactProps(**ball["props"]),
                                 "ball"))
    gs.add(CollisionGeometry(-1, HALFSPACE, np.zeros(3), np.eye(3),
                             np.zeros(1),
                             ContactProps(**model_cfg["ground"]), "ground"))
    model = mb.finalize(dtype=dtype_tables or torch.float32, device=device)
    contact = build_contact_model(gs, device=device)
    dt, iters = model_cfg["dt"], model_cfg["contact_iters"]
    fp = ContactForceParams(**model_cfg["force_params"])
    step = make_lane_step(model, contact, dt, contact_iters=iters,
                          force_params=fp)
    jac, jac_root = (make_lane_jac(model, contact, dt, contact_iters=iters,
                                   force_params=fp, root_seed=root)
                     for root in (False, True))
    return model, contact, step, jac, jac_root
