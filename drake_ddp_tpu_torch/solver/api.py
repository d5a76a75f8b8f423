"""Drop-in style class API over the per-scenario solve.

Port of ``drake_ddp_tpu/solver/api.py``: the same method names, array
layouts and printed iteration table, over :func:`~drake_ddp_tpu_torch.
solver.ilqr.solve_ilqr`:

    ilqr = IterativeLinearQuadraticRegulator(system, num_steps, beta=0.5)
    ilqr.SetInitialState(x0); ilqr.SetTargetState(x_nom)
    ilqr.SetRunningCost(dt*Q, dt*R); ilqr.SetTerminalCost(Qf)
    ilqr.SetInitialGuess(u_guess)
    states, inputs, solve_time, optimal_cost = ilqr.Solve()

It adds the device the solve runs on (``device="cuda"`` by default; a
multibody system must live there), and the solver's Jacobian route and
phase timer.  Inputs are numpy; outputs are numpy in the reference's
(n, N) / (m, N-1) layouts.  A failed linesearch raises RuntimeError after
the solve unless ``raise_on_divergence=False``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.multibody.plant import is_multibody
from drake_ddp_tpu_torch.solver import keypoints as kp
from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    ILQRStats,
    solve_ilqr,
)
from drake_ddp_tpu_torch.utils.timing import PhaseTimer


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _to_numpy(sol: ILQRSolution) -> ILQRSolution:
    np_ = lambda a: a.cpu().numpy()
    return ILQRSolution(*(
        ILQRStats(*map(np_, f)) if isinstance(f, ILQRStats) else np_(f)
        for f in sol))


class IterativeLinearQuadraticRegulator:
    """Set up and solve min_u sum (x-x_nom)'Q(x-x_nom) + u'Ru + terminal,
    s.t. x_{t+1} = f(x_t, u_t), via iLQR.

    ``device``: where the solve runs (resolved by
    :func:`~drake_ddp_tpu_torch.resolve_device`).  ``deriv_kernel``: the
    Jacobian route of :func:`solve_ilqr` (None: by the system).
    ``timer``: a :class:`~drake_ddp_tpu_torch.utils.timing.PhaseTimer`
    that every :meth:`Solve` adds its device phases to."""

    def __init__(
        self,
        system: DiscreteSystem,
        num_timesteps: int,
        delta: float = 1e-2,
        beta: float = 0.95,
        gamma: float = 0.0,
        derivs_keypoint_method: Optional[kp.DerivsInterpolation] = None,
        max_iters: int = 100,
        reg: Optional[float] = None,
        verbose: bool = True,
        raise_on_divergence: bool = True,
        parallel_backward: bool = False,
        dtype=None,
        device="cuda",
        deriv_kernel: Optional[str] = None,
        timer: Optional[PhaseTimer] = None,
    ):
        self.device = resolve_device(device)
        if is_multibody(system) and not _same_device(
                system.params[0].device, self.device):
            raise ValueError(
                f"the multibody system lives on {system.params[0].device}, "
                f"the solver was asked for {self.device}; build the system "
                "on the solver's device")
        self.system = system
        self.N = int(num_timesteps)
        self.n = system.n
        self.m = system.m
        derivs = (derivs_keypoint_method or kp.BASELINE).validate()
        self.config = ILQRConfig(
            num_steps=self.N,
            delta=float(delta),
            beta=float(beta),
            gamma=float(gamma),
            max_iters=int(max_iters),
            # None -> ILQRConfig's adaptive-regularization default
            **({} if reg is None else dict(reg=float(reg))),
            derivs=derivs,
            parallel_backward=bool(parallel_backward),
        )
        self.dtype = dtype or torch.float32
        self.verbose = verbose
        self.raise_on_divergence = raise_on_divergence
        self.deriv_kernel = deriv_kernel
        self.timer = timer

        # Problem data, defaults as in the reference.
        self.x0 = np.zeros(self.n)
        self.x_nom = np.zeros(self.n)
        self.Q = np.eye(self.n)
        self.R = np.eye(self.m)
        self.Qf = np.eye(self.n)
        self.u_guess = np.zeros((self.m, self.N - 1))

        self._solution: Optional[ILQRSolution] = None

    # -- problem definition API ------------------------------------------

    def SetInitialState(self, x0):
        self.x0 = np.asarray(x0).reshape(self.n)

    def SetTargetState(self, x_nom):
        self.x_nom = np.asarray(x_nom).reshape(self.n)

    def SetRunningCost(self, Q, R):
        Q, R = np.asarray(Q), np.asarray(R)
        assert Q.shape == (self.n, self.n)
        assert R.shape == (self.m, self.m)
        self.Q, self.R = Q, R

    def SetTerminalCost(self, Qf):
        Qf = np.asarray(Qf)
        assert Qf.shape == (self.n, self.n)
        self.Qf = Qf

    def SetInitialGuess(self, u_guess):
        u_guess = np.asarray(u_guess)
        assert u_guess.shape == (self.m, self.N - 1)
        self.u_guess = u_guess

    def SetControlLimits(self, u_min, u_max):
        # the reference's explicit no-op stub
        pass

    # -- solve ------------------------------------------------------------

    def _problem(self) -> ILQRProblem:
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)
        return ILQRProblem(x0=t(self.x0), x_nom=t(self.x_nom), Q=t(self.Q),
                           R=t(self.R), Qf=t(self.Qf),
                           u_init=t(self.u_guess.T))    # to time-major

    def _solve(self, timer):
        st = time.time()
        sol = _to_numpy(solve_ilqr(self.system, self.config, self._problem(),
                                   deriv_kernel=self.deriv_kernel,
                                   timer=timer))
        solve_time = time.time() - st
        self._solution = sol
        if self.verbose:
            self._print_table(sol, solve_time)
        if sol.diverged and self.raise_on_divergence:
            raise RuntimeError(
                "linesearch failed (eps < %g)" % self.config.eps_min)
        return sol.x.T, sol.u.T, solve_time, float(sol.cost)

    def Solve(self):
        """Solve and return (x (n, N), u (m, N-1), solve_time,
        optimal_cost), the reference's Solve() contract."""
        return self._solve(self.timer)

    def SolveProfiled(self):
        """:meth:`Solve` with the device time of each solver phase
        (rollout, jac, derivs, riccati; CUDA events, so on the card only):
        returns the Solve() contract plus a dict of milliseconds."""
        if self.device.type != "cuda":
            raise ValueError("SolveProfiled times the card with CUDA "
                             "events; use device='cuda'")
        timer = PhaseTimer()
        out = self._solve(timer)
        return out + (timer.totals_ms(),)

    def _print_table(self, sol: ILQRSolution, solve_time: float):
        bar = "-" * 80
        print(bar)
        print("|    iter    |    cost    |    eps    |    ls    | derivs '%' |")
        print(bar)
        for i in range(int(sol.iterations)):
            print(
                f"{i + 1:^14}{sol.stats.cost[i]:11.4f}  "
                f"{sol.stats.eps[i]:^12.4f}{int(sol.stats.ls_iters[i]):^11}"
                f"   {sol.stats.percent_derivs[i]:.1f}"
            )
        print(f"total solve time: {solve_time:.4f} s")

    def SolveDirectTranscription(self, tcfg=None):
        """Solve the same problem with the direct-transcription baseline
        (the reference's SQP comparison path) and return the Solve()
        contract (x (n, N), u (m, N-1), solve_time, cost)."""
        from drake_ddp_tpu_torch.solver.transcription import (
            TranscriptionConfig,
            solve_transcription,
        )

        tcfg = tcfg or TranscriptionConfig(num_steps=self.N)
        st = time.time()
        sol = solve_transcription(self.system, tcfg, self._problem())
        x, u = sol.x.cpu().numpy(), sol.u.cpu().numpy()
        cost = float(sol.cost)
        solve_time = time.time() - st
        if self.verbose:
            print(f"transcription defect: {float(sol.defect):.2e}, "
                  f"objective: {float(sol.objective):.4f}")
        return x.T, u.T, solve_time, cost

    # -- persistence --------------------------------------------------------

    def SaveSolution(self, fname: str):
        """Save (t, x_bar, u_bar, K) to .npz (:func:`~drake_ddp_tpu_torch.
        io.solution.save_solution`); the feedback law
        u = u_bar - K (x - x_bar) stabilizes the trajectory."""
        from drake_ddp_tpu_torch.io.solution import save_solution

        if self._solution is None:
            raise RuntimeError("call Solve() before SaveSolution()")
        sol = self._solution
        save_solution(fname, self.system.dt, sol.x.T, sol.u.T,
                      np.moveaxis(sol.K, 0, -1))
