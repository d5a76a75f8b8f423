"""Everything the benchmark takes from the program under test, the port
``drake_ddp_tpu_torch``, in one place: its entry points, its problem and
solver records, its kernel build, its phase timer and its launch
counters.  The port is imported on first use, never by the benchmark's
other modules, and nothing of the JAX package is.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable


class Program:
    """The port's surface the benchmark drives."""

    def __init__(self):
        from drake_ddp_tpu_torch.mpc.driver import (MPCConfig,
                                                    mpc_solve_batched)
        from drake_ddp_tpu_torch.solver import keypoints
        from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
        from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                     scenario_routes)
        from drake_ddp_tpu_torch.utils.timing import PhaseTimer
        self.MPCConfig, self.mpc_solve_batched = MPCConfig, mpc_solve_batched
        self.ILQRConfig, self.ILQRProblem = ILQRConfig, ILQRProblem
        self.solve_ilqr_batched = solve_ilqr_batched
        self.scenario_routes = scenario_routes
        self.PhaseTimer = PhaseTimer
        self._keypoints = keypoints

    def build_kernels(self, names: Iterable[str]) -> None:
        """Build (or find built, in the checkout's ``build/``) the kernel
        libraries a cell launches, all at once."""
        from drake_ddp_tpu_torch.ops import _cuda
        _cuda.build(list(names))

    def build_system(self, cfg: Dict, device):
        """The system under test: the example's model at the
        configuration's settings, on ``device``."""
        ex = importlib.import_module(
            f"drake_ddp_tpu_torch.examples.{cfg['program']['example']}")
        system, _ = ex.build_system(ex.Config(**cfg["program"]["config"]),
                                    device=device)
        return system

    def ilqr_config(self, cfg: Dict):
        s = cfg["solver"]
        kp = s["keypoints"]
        derivs = self._keypoints.DerivsInterpolation(kp["method"],
                                                     minN=kp["minN"])
        ceiling = s["cost_ceiling"]
        return self.ILQRConfig(
            num_steps=cfg["N"], delta=s["delta"], beta=s["beta"],
            gamma=s["gamma"], max_iters=s["max_iters"], eps_min=s["eps_min"],
            cost_ceiling=float("inf") if ceiling is None else ceiling,
            reg=s["reg"], reg_mult=s["reg_mult"], reg_max=s["reg_max"],
            derivs=derivs, ls_parallel=s["ls_parallel"],
            ls_expected_floor=s["ls_expected_floor"])

    def solve_starts(self, system, cfg, prob, u_inits, timer=None):
        """Every start's solution (a batched ``ILQRSolution``): ``prob``
        (no batch axis) solved from each of the (K, N-1, m) tapes
        ``u_inits`` in one batched solve on the per-scenario kernels, the
        call ``solver/multistart.solve_starts`` makes before it keeps the
        best."""
        K = u_inits.shape[0]
        tile = lambda a: None if a is None else a[None].expand(
            K, *a.shape).contiguous()
        probs = self.ILQRProblem(*map(tile, prob))._replace(
            u_init=u_inits.to(prob.u_init.dtype))
        return self.solve_ilqr_batched(system, cfg, probs, timer=timer,
                                       **self.scenario_routes(system))

    @staticmethod
    def counters() -> Dict[str, int]:
        """The port's launch and host-synchronisation counts."""
        from drake_ddp_tpu_torch.ops.megajac import megajac
        from drake_ddp_tpu_torch.ops.megaroll import megaroll
        from drake_ddp_tpu_torch.solver.batched import any_lane
        return {"megaroll_launches": megaroll.launches,
                "megajac_launches": megajac.launches,
                "host_syncs": any_lane.syncs}

    @staticmethod
    def zero_counters() -> None:
        from drake_ddp_tpu_torch.ops.megajac import megajac
        from drake_ddp_tpu_torch.ops.megaroll import megaroll
        from drake_ddp_tpu_torch.solver.batched import any_lane
        megaroll.launches = megajac.launches = any_lane.syncs = 0
