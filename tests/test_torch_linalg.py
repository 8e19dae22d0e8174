"""Port parity for ``ops/linalg.py``: the unrolled Cholesky, the two
triangular solves and ``spd_solve`` against the JAX package's functions
and numpy on the same SPD matrices, made with numpy from a seed, at n = 16
(GR1T1's 6 + 10) and n = 38 (the 32-DOF body's 6 + 32), and the large
branch (n = 60) against ``jax.scipy``'s Cholesky solve.

Tolerances: in float32, rtol 1e-4 / atol 1e-5 relative to the solution's
scale (the matrices' condition numbers are ~1e3, so the float32 results
differ from float64 by ~1e-5 relatively); in float64 against numpy, 1e-10.
The forward solve rounds as the JAX package's (its per-row sums in the
same order): it must equal JAX's at the same inputs within 2 ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.ops import linalg as jl
from wiki_grx_gym_tpu_torch.ops import linalg as tl


def spd(n, batch=8, seed=0):
    """(batch, n, n) SPD matrices with a spread of scales like a mass
    matrix (float64), and right-hand sides (batch, n)."""
    rng = np.random.RandomState(seed + n)
    a = rng.randn(batch, n, n)
    scale = np.exp(rng.uniform(-2.0, 2.0, n))
    m = a @ a.transpose(0, 2, 1) / n + np.eye(n)
    m = m * np.sqrt(scale[:, None] * scale[None, :])
    return m, rng.randn(batch, n)


@pytest.mark.parametrize("n", [16, 38])
def test_cholesky_matches_jax_and_numpy(n):
    m, _ = spd(n)
    got = tl.cholesky_unrolled(torch.from_numpy(m.astype(np.float32))).numpy()
    want = np.asarray(jl.cholesky_unrolled(jnp.asarray(m.astype(np.float32))))
    ref = np.linalg.cholesky(m)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)
    assert np.all(np.triu(got, 1) == 0.0)
    np.testing.assert_allclose(tl.cholesky_unrolled(torch.from_numpy(m)).numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [16, 38])
def test_triangular_solves_match_jax(n):
    m, b = spd(n, seed=1)
    l32 = np.linalg.cholesky(m).astype(np.float32)
    b32 = b.astype(np.float32)
    y = tl.solve_lower(torch.from_numpy(l32), torch.from_numpy(b32)).numpy()
    jy = np.asarray(jl.solve_lower(jnp.asarray(l32), jnp.asarray(b32)))
    np.testing.assert_array_max_ulp(y, jy, maxulp=2)
    x = tl.solve_upper_t(torch.from_numpy(l32), torch.from_numpy(y)).numpy()
    jx = np.asarray(jl.solve_upper_t(jnp.asarray(l32), jnp.asarray(jy)))
    np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-5 * np.abs(jx).max())
    # float64 against numpy's triangular solves
    l64 = np.linalg.cholesky(m)
    y64 = tl.solve_lower(torch.from_numpy(l64), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y64, np.linalg.solve(l64, b[..., None])[..., 0], rtol=1e-10, atol=1e-10)
    x64 = tl.solve_upper_t(torch.from_numpy(l64), torch.from_numpy(y64)).numpy()
    np.testing.assert_allclose(x64, np.linalg.solve(l64.transpose(0, 2, 1), y64[..., None])[..., 0],
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n", [16, 38, 60])
def test_spd_solve_matches_jax_and_numpy(n):
    m, b = spd(n, seed=2)
    got = tl.spd_solve(torch.from_numpy(m.astype(np.float32)), torch.from_numpy(b.astype(np.float32))).numpy()
    want = np.asarray(jl.spd_solve(jnp.asarray(m.astype(np.float32)), jnp.asarray(b.astype(np.float32))))
    ref = np.linalg.solve(m, b[..., None])[..., 0]
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    got64 = tl.spd_solve(torch.from_numpy(m), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got64, ref, rtol=1e-10, atol=1e-10 * scale)


def test_floor_keeps_a_singular_matrix_finite():
    """The 1e-12 diagonal floor: a zero matrix factors to zeros (0 / 1e-6,
    no 0 / 0 NaN), as in the JAX package."""
    z = np.zeros((2, 16, 16), np.float32)
    got = tl.cholesky_unrolled(torch.from_numpy(z)).numpy()
    want = np.asarray(jl.cholesky_unrolled(jnp.asarray(z)))
    np.testing.assert_array_equal(got, want)
    assert np.all(got == 0.0)


def test_gradient_flows_through_the_solve():
    """float64 autograd through ``spd_solve`` equals the analytic
    derivative d x / d b = A^-1 (the dynamics' autograd checks rely on it)."""
    m, b = spd(16, batch=1, seed=3)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = tl.spd_solve(torch.from_numpy(m), bt)
    (g,) = torch.autograd.grad(x[0, 3], bt)
    np.testing.assert_allclose(g.numpy()[0], np.linalg.inv(m[0])[3], rtol=1e-9, atol=1e-12)
