"""The discrete multibody step bundled as a DiscreteSystem.

Port of ``drake_ddp_tpu/multibody/plant.py``.  The system carries the
plain lane-major step (:mod:`multibody.lanestep`, which the CUDA kernels
mirror), the structured-IFT lane Jacobians (:mod:`multibody.lanejac`)
and the per-scenario step :func:`multibody_step`.

The per-scenario step is the lane step at one lane.  Where the contact
velocity is solved implicitly (contact_iters >= 1), its derivatives are
those of the implicit function theorem at the step's own Newton root,
which is what ``jax.jacfwd`` through the JAX step's ``lax.custom_root``
returns: the step is one ``torch.autograd.Function`` whose forward- and
reverse-mode rules contract with the cold lane Jacobian at its inputs.
The explicit step (contact_iters == 0, or no contact) has no such rule
and is differentiated through its arithmetic, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from drake_ddp_tpu_torch.contact.forces import ContactForceParams
from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac
from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step
from drake_ddp_tpu_torch.multibody.model import MultibodyModel


def _contract(J, d):
    """sum_j J[:, j, l] d[j, l]: J (n, k, L), d (k, L) -> (n, L)."""
    return torch.sum(J * d[None], dim=1)


class _ImplicitStep(torch.autograd.Function):
    """x_next = step(x, u) on lanes, x (n, L), u (m, L), differentiated by
    the lane Jacobian ``jac(x, u) -> (fx (n, n, L), fu (n, m, L))``.

    ``torch.func`` transforms reach it through ``setup_context`` and the
    ``jvp``, ``backward`` and ``vmap`` rules; the vmap rule folds the
    vmapped dimension into the lanes, so ``vmap`` of the per-scenario
    step is one lane step and its derivatives one lane Jacobian."""

    @staticmethod
    def forward(x, u, step, jac):
        return step(x, u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, u, _step, jac = inputs
        ctx.jac = jac
        ctx.save_for_forward(x, u)
        ctx.save_for_backward(x, u)

    @staticmethod
    def jvp(ctx, dx, du, _dstep, _djac):
        fx, fu = ctx.jac(*ctx.saved_tensors)
        out = 0.0
        if dx is not None:
            out = out + _contract(fx, dx)
        if du is not None:
            out = out + _contract(fu, du)
        return out

    @staticmethod
    def backward(ctx, g):
        fx, fu = ctx.jac(*ctx.saved_tensors)
        gx = torch.sum(fx * g[:, None], dim=0)
        gu = torch.sum(fu * g[:, None], dim=0)
        return gx, gu, None, None

    @staticmethod
    def vmap(info, in_dims, x, u, step, jac):
        B = info.batch_size

        def fold(a, d):                  # (..B at d.., rows, L) -> (rows, L*B)
            a = (a.unsqueeze(-1).expand(*a.shape, B) if d is None
                 else a.movedim(d, -1))
            return a.reshape(a.shape[0], -1)

        out = _ImplicitStep.apply(fold(x, in_dims[0]), fold(u, in_dims[1]),
                                  step, jac)
        return out.reshape(out.shape[0], -1, B), -1


def _scenario_step(lane_step: Callable, lane_jac: Optional[Callable],
                  x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The per-scenario step x (n,), u (m,) -> x_next (n,) as the lane
    step at one lane; differentiated by the cold lane Jacobian
    ``lane_jac`` when it is given, else through the step."""
    if lane_jac is None:
        return lane_step(x[:, None], u[:, None])[:, 0]
    return _ImplicitStep.apply(x[:, None], u[:, None], lane_step,
                               lane_jac)[:, 0]


def is_multibody(system: DiscreteSystem) -> bool:
    """Whether ``system`` steps a multibody model (params = (model,
    contact), as :func:`make_multibody_system` builds it)."""
    return (isinstance(system.params, tuple) and len(system.params) == 2
            and isinstance(system.params[0], MultibodyModel))


def _implicit(contact, contact_iters):
    return contact is not None and contact.num_contacts > 0 \
        and contact_iters >= 1


def multibody_step(
    model: MultibodyModel,
    contact: Optional[ContactModel],
    dt: float,
    x: torch.Tensor,
    u: torch.Tensor,
    contact_iters: int = 2,
    force_params: ContactForceParams = ContactForceParams(),
) -> torch.Tensor:
    """One discrete step x' = f(x, u) of one scenario, x = [q; v] (n,).

    Builds the step for this call; a system from
    :func:`make_multibody_system` builds it once."""
    lane = make_lane_step(model, contact, dt, contact_iters=contact_iters,
                          force_params=force_params)
    jac = (make_lane_jac(model, contact, dt, contact_iters=contact_iters,
                         force_params=force_params)
           if _implicit(contact, contact_iters) else None)
    return _scenario_step(lane, jac, x, u)


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
    # the implicit contact path has the IFT Jacobians, cold-Newton and
    # root-seeded; the explicit contact_iters == 0 step has none
    lane_jac = lane_jac_root = None
    has_contact = contact is not None and contact.num_contacts > 0
    if not has_contact or contact_iters >= 1:
        lane_jac, lane_jac_root = (
            make_lane_jac(model, contact, dt, contact_iters=contact_iters,
                          force_params=force_params, root_seed=root)
            for root in (False, True))
    ift_jac = lane_jac if _implicit(contact, contact_iters) else None
    return DiscreteSystem(
        step_fn=lambda params, x, u: _scenario_step(lane, ift_jac, x, u),
        params=(model, contact),
        n=model.nq + model.nv,
        m=model.nu,
        dt=dt,
        lane_step_fn=lane,
        lane_jac_fn=lane_jac,
        lane_jac_root_fn=lane_jac_root,
    )
