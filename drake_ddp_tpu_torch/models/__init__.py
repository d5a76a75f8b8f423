"""Embedded robot models (generated data modules, see registry.py), and
the cart-pole's SDF file (``CART_POLE_SDF``, for
:func:`drake_ddp_tpu_torch.io.sdf.parse_sdf`)."""

from pathlib import Path

from drake_ddp_tpu_torch.models.registry import (
    gripper_articulated,
    gripper_static,
    kinova_gen3,
    mini_cheetah,
    panda_fr3,
    robot_from_data,
)

CART_POLE_SDF = str(Path(__file__).resolve().parent / "cart_pole.sdf")

__all__ = ["CART_POLE_SDF", "gripper_articulated", "gripper_static",
           "kinova_gen3", "mini_cheetah", "panda_fr3", "robot_from_data"]
