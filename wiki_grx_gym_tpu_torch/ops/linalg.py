"""Batched small-matrix linear algebra for the engine's dense solve.

Port of ``wiki_grx_gym_tpu/ops/linalg.py``. The matrix size (6 + num_dof)
is static, so the Cholesky factorization is written out over it as the
same right-looking program: each step factors the leading column of a
shrinking trailing block (the diagonal floored at 1e-12) and updates the
rest by a rank-1 product. The triangular solves eliminate one column per
step (a few batched ops a column instead of one a product): the forward
solve then subtracts each row's products in the JAX package's order and
rounds as it does; the backward solve subtracts them in the reverse
order.

Used by the articulated-body solve (``sim/dynamics.py``). Matrices larger
than 48 take ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``, as
the JAX package takes ``jax.scipy.linalg.cho_factor`` there. Its ``info`` is
not read: a failed factorization does not raise, as JAX's does not, and
nothing waits for the device to check the error code (a CUDA graph's
capture cannot).
"""

from __future__ import annotations

import torch


def cholesky_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of SPD ``a`` (..., n, n)."""
    n = a.shape[-1]
    out = torch.zeros_like(a)
    for j in range(n):
        d = torch.sqrt(torch.clamp(a[..., 0, 0], min=1e-12))
        col = a[..., :, 0] / d[..., None]            # (..., n - j), diagonal first
        out[..., j:, j] = col
        if j + 1 < n:
            tail = col[..., 1:]
            a = a[..., 1:, 1:] - tail[..., :, None] * tail[..., None, :]
    return out


def solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b with lower-triangular L; b is (..., n)."""
    n = l.shape[-1]
    ys = []
    acc = b
    for i in range(n):
        y = acc[..., 0] / l[..., i, i]
        ys.append(y)
        # row k's running sum: b_k - l_k0 y_0 - l_k1 y_1 - ..., column by column
        acc = acc[..., 1:] - l[..., i + 1:, i] * y[..., None]
    return torch.stack(ys, dim=-1)


def solve_upper_t(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y with lower-triangular L; y is (..., n)."""
    n = l.shape[-1]
    xs = [None] * n
    acc = y
    for i in reversed(range(n)):
        xs[i] = acc[..., i] / l[..., i, i]
        if i:
            acc = acc[..., :i] - l[..., i, :i] * xs[i][..., None]
    return torch.stack(xs, dim=-1)


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for SPD ``a`` (..., n, n) and right-hand side (..., n)."""
    n = a.shape[-1]
    if n > 48:
        c, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(b[..., None], c)[..., 0]
    l = cholesky_unrolled(a)
    return solve_upper_t(l, solve_lower(l, b))
