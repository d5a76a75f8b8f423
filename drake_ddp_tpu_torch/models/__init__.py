"""Embedded robot models (generated data modules, see registry.py)."""

from drake_ddp_tpu_torch.models.registry import (
    gripper_articulated,
    gripper_static,
    kinova_gen3,
    mini_cheetah,
    panda_fr3,
    robot_from_data,
)

__all__ = ["gripper_articulated", "gripper_static", "kinova_gen3",
           "mini_cheetah", "panda_fr3", "robot_from_data"]
