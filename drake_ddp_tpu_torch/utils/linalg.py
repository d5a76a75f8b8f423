"""Small batched SPD solves.

Port of ``solve_spd`` from ``drake_ddp_tpu/utils/linalg.py``, which backs
the Riccati gain solve.  The JAX package writes the Cholesky out by hand
to keep TPU programs small; here it is one batched ``torch.linalg``
factorization (unpivoted, so the factor is the same unique Cholesky
factor) and two batched triangular solves.  ``cholesky_ex`` reports failure per
matrix without a host synchronisation; a matrix that is not positive
definite gets a NaN solution, as the hand-written factorization's
square root of a negative pivot gives in the JAX package, so the
solver's linesearch rejects the step instead of an exception stopping
the whole batch.
"""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A.  A (..., n, n); b (..., n) or
    (..., n, k)."""
    vec = b.dim() == A.dim() - 1
    rhs = b[..., None] if vec else b
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x
