"""Embedded robot models (generated data modules, see registry.py)."""

from drake_ddp_tpu_torch.models.registry import mini_cheetah, robot_from_data

__all__ = ["mini_cheetah", "robot_from_data"]
