"""Solution persistence: the time-varying LQR policy as an .npz archive.

Port of ``drake_ddp_tpu/io/solution.py``, the reference's
``SaveSolution`` format: arrays ``t (N-1,)``, ``x_bar (n, N-1)`` (last
step dropped), ``u_bar (m, N-1)``, ``K (m, n, N-1)``.  The archive is a
time-varying LQR policy: u(t) = u_bar[t] - K[t] (x - x_bar[t]).  Host
numpy only, so a file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_solution(fname: str, dt: float, x: np.ndarray, u: np.ndarray,
                  K: np.ndarray) -> None:
    """Write the archive.

    Args:
        fname: output path (numpy appends .npz if missing).
        dt: the timestep.
        x: (n, N) state trajectory.
        u: (m, N-1) control tape.
        K: (m, n, N-1) feedback gains.
    """
    N = x.shape[1]
    t = np.arange(0.0, (N - 1) * dt, dt)
    np.savez(fname, t=t, x_bar=x[:, :-1], u_bar=u, K=K)


def load_solution(fname: str) -> Dict[str, np.ndarray]:
    """Load a saved solution: a dict with t, x_bar, u_bar, K."""
    data = np.load(fname)
    return {k: data[k] for k in ("t", "x_bar", "u_bar", "K")}


def policy(sol: Dict[str, np.ndarray]):
    """A loaded solution as the feedback law u(t_index, x)."""
    x_bar, u_bar, K = sol["x_bar"], sol["u_bar"], sol["K"]

    def act(i: int, x: np.ndarray) -> np.ndarray:
        return u_bar[:, i] - K[:, :, i] @ (x - x_bar[:, i])

    return act
