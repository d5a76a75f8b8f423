"""Reconstruct host-side robot records from embedded data modules.

Port of ``drake_ddp_tpu/models/registry.py`` for the robots this slice
runs (the mini cheetah); the manipulation robots come with their slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from drake_ddp_tpu_torch.contact.geometry import ContactProps
from drake_ddp_tpu_torch.io.urdf import (UrdfCollision, UrdfJoint, UrdfLink,
                                         UrdfRobot)


def _props(d: Dict) -> ContactProps:
    return ContactProps(
        modulus=np.inf if d["modulus"] is None else d["modulus"],
        dissipation=d["dissipation"],
        mu_static=d["mu_static"],
        mu_dynamic=d["mu_dynamic"],
        resolution_hint=d["resolution_hint"],
    )


def robot_from_data(model: Dict) -> UrdfRobot:
    """A UrdfRobot record from a generated MODEL dict (accepted by
    ``add_urdf``)."""
    links = {
        name: UrdfLink(name=name, mass=l["mass"], com=np.asarray(l["com"]),
                       inertia=np.asarray(l["inertia"]), collisions=[])
        for name, l in model["links"].items()
    }
    for c in model["collisions"]:
        links[c["link"]].collisions.append(UrdfCollision(
            kind=c["kind"], pos=np.asarray(c["pos"]),
            rot=np.asarray(c["rot"]), size=np.asarray(c["size"]),
            mesh_file=None, props=_props(c["props"])))
    joints = [
        UrdfJoint(name=j["name"], type=j["type"], parent=j["parent"],
                  child=j["child"], origin_pos=np.asarray(j["origin_pos"]),
                  origin_rot=np.asarray(j["origin_rot"]),
                  axis=np.asarray(j["axis"]), damping=j["damping"],
                  actuated=j["actuated"], armature=j["armature"])
        for j in model["joints"]
    ]
    return UrdfRobot(
        name=model["name"], links=links, joints=joints, root=model["root"],
        filtered_link_pairs=[tuple(p) for p in model["filtered_link_pairs"]],
        dir=".")


def mini_cheetah() -> UrdfRobot:
    """MIT Mini Cheetah: floating base + 12 actuated leg joints, body box
    + 4 foot spheres."""
    from drake_ddp_tpu_torch.models._data_mini_cheetah import MODEL
    return robot_from_data(MODEL)
