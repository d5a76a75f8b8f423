"""The discrete multibody step bundled as a DiscreteSystem.

Port of the lane half of ``drake_ddp_tpu/multibody/plant.py``
(``make_multibody_system``): the system carries the plain lane-major step
(:mod:`multibody.lanestep`, which the CUDA kernels mirror) and the
structured-IFT lane Jacobians (:mod:`multibody.lanejac`).  The
per-scenario ``multibody_step`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional

from drake_ddp_tpu_torch.contact.forces import ContactForceParams
from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac
from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step
from drake_ddp_tpu_torch.multibody.model import MultibodyModel


def make_multibody_system(
    model: MultibodyModel,
    contact: Optional[ContactModel],
    dt: float,
    contact_iters: int = 2,
    force_params: ContactForceParams = ContactForceParams(),
) -> DiscreteSystem:
    """Bundle a model + contact scene into the solver's DiscreteSystem.
    The system lives on the model's device."""
    lane = make_lane_step(model, contact, dt, contact_iters=contact_iters,
                          force_params=force_params)
    # the implicit contact path has the IFT Jacobian; the explicit
    # contact_iters == 0 step has none
    lane_jac_root = None
    has_contact = contact is not None and contact.num_contacts > 0
    if not has_contact or contact_iters >= 1:
        lane_jac_root = make_lane_jac(model, contact, dt,
                                      contact_iters=contact_iters,
                                      force_params=force_params,
                                      root_seed=True)
    return DiscreteSystem(
        step_fn=None,
        params=(model, contact),
        n=model.nq + model.nv,
        m=model.nu,
        dt=dt,
        lane_step_fn=lane,
        lane_jac_root_fn=lane_jac_root,
    )
