"""Parity of the port's Cholesky route (potrf, potrs, potri, the solver's
``cholesky`` branches and the flop model) with the JAX package, on the CPU.

Every case of ``tests/test_cholesky.py`` runs the same seeded numpy input
through the JAX function and the port. Tolerances, each with its reason:
- L and the inverse: within 1e-5 in relative Frobenius norm of the JAX
  package's (inputs ``G G^T/n + I``, condition number <= 5; both run the
  same blocked algorithm in FP32, summing products in other orders;
  measured <= 3e-7). fp64: 1e-12.
- ``ok``: identical to the JAX package's, on SPD and indefinite input.
- Against numpy: the JAX tests' own tolerances.
- A junk upper triangle: the factor, the refined solve and the polished
  inverse bit-identical to those of the same matrix with zeros above the
  diagonal (only the lower triangle is read).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gpu_matrix_inversion_tpu as jmi  # noqa: E402
import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu.ops import cholesky as jchol  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import cholesky as tchol  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)


def spd_matrix(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n))
    return ((b @ b.T) / n + np.eye(n)).astype(dtype)


def _frob(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_factor(a, **kw):
    low, ok = jchol.cholesky_factor(a, **kw)
    return np.asarray(low), np.asarray(ok)


@pytest.mark.parametrize("n,block_size", [(64, 128), (200, 128), (384, 128),
                                          (1200, 64)])
def test_factor_matches_jax_and_numpy(n, block_size):
    """potrf against the JAX package (1e-5 Frobenius, ok identical) and
    numpy (the JAX test's 2e-4 / 2e-5; 5e-4 / 5e-5 at n = 1200). n = 200
    takes the identity padding; n = 1200 at b = 64 the chunked syrk
    (1152 trailing rows, strips of 320 columns)."""
    a = spd_matrix(n, seed=n if n != 1200 else 77)
    want, want_ok = _jax_factor(a, block_size=block_size)
    low, ok = tchol.cholesky_factor(_t(a), block_size=block_size)
    assert bool(ok) == bool(want_ok) is True
    assert _frob(low, want) <= 1e-5
    tol = (5e-4, 5e-5) if n == 1200 else (2e-4, 2e-5)
    np.testing.assert_allclose(low.numpy(), np.linalg.cholesky(a),
                               rtol=tol[0], atol=tol[1])
    assert np.all(np.triu(low.numpy(), 1) == 0)


@pytest.mark.parametrize("n,block_size", [(96, 32), (1200, 64)])
def test_factor_reads_lower_triangle_only(n, block_size):
    """LAPACK uplo='L': junk above the diagonal gives the same factor, bit
    for bit, as zeros there (also through the chunked syrk, whose strips
    stop at their own diagonal block)."""
    a = spd_matrix(n, seed=5)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 333.0
    low = np.tril(a)
    l1, ok1 = tchol.cholesky_factor(_t(low), block_size=block_size)
    l2, ok2 = tchol.cholesky_factor(_t(junk), block_size=block_size)
    assert bool(ok1) and bool(ok2)
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    want, _ = _jax_factor(junk, block_size=block_size)
    assert _frob(l2, want) <= 1e-5


def test_factor_batched_and_fp64():
    """A (4, 128^2) batch in one call, and fp64 (1e-12 of the JAX package,
    the JAX test's 1e-12 / 1e-13 of numpy)."""
    batch = np.stack([spd_matrix(128, seed=10 + i) for i in range(4)])
    want, want_ok = _jax_factor(batch)
    low, ok = tchol.cholesky_factor(_t(batch))
    assert ok.tolist() == want_ok.tolist() == [True] * 4
    for i in range(4):
        assert _frob(low[i], want[i]) <= 1e-5
        np.testing.assert_allclose(low[i].numpy(),
                                   np.linalg.cholesky(batch[i]),
                                   rtol=2e-4, atol=2e-5)
    a64 = spd_matrix(160, seed=3, dtype=np.float64)
    want64, _ = _jax_factor(a64, block_size=64)
    l64, ok64 = tchol.cholesky_factor(_t(a64), block_size=64)
    assert bool(ok64) and l64.dtype == torch.float64
    assert _frob(l64, want64) <= 1e-12
    np.testing.assert_allclose(l64.numpy(), np.linalg.cholesky(a64),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("where", [0, 24, 47])
def test_non_spd_flags_not_ok_in_both(where):
    """One diagonal entry set to -50 (in the first, a middle and the last
    diagonal block): ok False from potrf and potri in both packages, no
    exception; the same for the batch member alone."""
    n = 48
    a = spd_matrix(n, seed=7)
    a[where, where] = -50.0
    _, ok_j = _jax_factor(a)
    _, ok_t = tchol.cholesky_factor(_t(a))
    assert bool(ok_j) is bool(ok_t) is False
    _, okinv_j = jchol.cholesky_inverse(a)
    _, okinv_t = tchol.cholesky_inverse(_t(a))
    assert bool(okinv_j) is bool(okinv_t) is False
    batch = np.stack([spd_matrix(n, seed=8), a, spd_matrix(n, seed=9)])
    _, okb_j = jchol.cholesky_inverse(batch)
    _, okb_t = tchol.cholesky_inverse(_t(batch))
    assert okb_t.tolist() == np.asarray(okb_j).tolist() == [True, False,
                                                            True]


def test_solve_matches_jax_and_numpy():
    """potrs with matrix and vector right-hand sides: within 1e-5 of the JAX
    package (relative Frobenius) and the JAX test's 5e-3 / 5e-4 of numpy;
    the vector form within 1e-5 of the matrix form's first column and of
    the JAX vector solve (the triangular solves of one and of three
    columns sum in other orders: the JAX test's bitwise-close default does
    not hold for a library solve)."""
    n = 192
    a = spd_matrix(n, seed=21)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    lj, _ = jchol.cholesky_factor(a, block_size=64)
    xj, okj = jchol.cholesky_solve(lj, b)
    low, ok_f = tchol.cholesky_factor(_t(a), block_size=64)
    x, ok_s = tchol.cholesky_solve(low, _t(b))
    assert bool(ok_f) and bool(ok_s) and bool(okj)
    assert _frob(x, xj) <= 1e-5
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b),
                               rtol=5e-3, atol=5e-4)
    xv, ok_v = tchol.cholesky_solve(low, _t(b[:, 0]))
    xvj, _ = jchol.cholesky_solve(lj, b[:, 0])
    assert bool(ok_v) and tuple(xv.shape) == (n,)
    assert _frob(xv, x[:, 0]) <= 1e-5 and _frob(xv, xvj) <= 1e-5


@pytest.mark.parametrize("n", [96, 320])
def test_potri_residual_and_dispatch(n):
    """potri within 1e-5 of the JAX package and under the JAX test's
    residual gate (1e-5); ``inverse(method="cholesky")`` is the same call,
    bit for bit."""
    a = spd_matrix(n, seed=30 + n)
    want, want_ok = jchol.cholesky_inverse(a)
    inv, ok = tchol.cholesky_inverse(_t(a))
    assert bool(ok) == bool(want_ok) is True
    assert _frob(inv, want) <= 1e-5
    assert relative_residual(a, inv.numpy()) < 1e-5
    inv2, ok2 = tmi.inverse(_t(a), method="cholesky")
    assert bool(ok2)
    np.testing.assert_array_equal(inv.numpy(), inv2.numpy())


def test_potri_batched():
    batch = np.stack([spd_matrix(64, seed=40 + i) for i in range(3)])
    want, _ = jchol.cholesky_inverse(batch)
    inv, ok = tchol.cholesky_inverse(_t(batch))
    assert ok.tolist() == [True] * 3
    for i in range(3):
        assert relative_residual(batch[i], inv[i].numpy()) < 1e-5
        assert _frob(inv[i], np.asarray(want)[i]) <= 1e-5


def test_potri_2d_schedule_matches(monkeypatch):
    """MATINV_POTRI_PRODUCT=2d's tiling (read at import; patched here)
    gives the inverse within 1e-5 of the column schedule's, at a size with
    several 512 chunks."""
    a = spd_matrix(1100, seed=11)
    cols, ok_c = tchol.cholesky_inverse(_t(a))
    monkeypatch.setattr(tchol, "_POTRI_PRODUCT_2D", True)
    tiled, ok_t = tchol.cholesky_inverse(_t(a))
    assert bool(ok_c) and bool(ok_t)
    assert _frob(tiled, cols) <= 1e-5


def test_solve_dispatch_cholesky():
    """solve(method='cholesky') runs potrf + potrs (within 1e-5 of the JAX
    solve), refinement reusing the factor never substantially degrades the
    residual, and a vector right-hand side works."""
    n = 160
    a = spd_matrix(n, seed=55)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    xj, _ = jmi.solve(a, b, method="cholesky")
    x, ok = tmi.solve(_t(a), _t(b), method="cholesky")
    assert bool(ok)
    assert _frob(x, xj) <= 1e-5
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b),
                               rtol=5e-3, atol=5e-4)
    xr, okr = tmi.solve(_t(a), _t(b), method="cholesky", refine_iters=2)
    xrj, _ = jmi.solve(a, b, method="cholesky", refine_iters=2)
    assert bool(okr)
    assert _frob(xr, xrj) <= 1e-5
    r0 = np.abs(a @ x.numpy() - b).max()
    r1 = np.abs(a @ xr.numpy() - b).max()
    assert r1 <= r0 * 1.5
    xv, okv = tmi.solve(_t(a), _t(b[:, 0]), method="cholesky")
    assert bool(okv) and tuple(xv.shape) == (n,)


def test_solve_cholesky_refine_ignores_upper_junk():
    """The refinement residual uses the matrix the factor read: with junk
    above the diagonal, x is bit-identical to that of the lower triangle
    alone, and within the JAX test's 1e-5 / 1e-6 of the clean solve."""
    n = 96
    a = spd_matrix(n, seed=13)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 444.0
    rng = np.random.default_rng(4)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    x0, ok0 = tmi.solve(_t(a), _t(b), method="cholesky", refine_iters=2)
    xl, okl = tmi.solve(_t(np.tril(a)), _t(b), method="cholesky",
                        refine_iters=2)
    xj, okj = tmi.solve(_t(junk), _t(b), method="cholesky", refine_iters=2)
    assert bool(ok0) and bool(okl) and bool(okj)
    np.testing.assert_array_equal(xj.numpy(), xl.numpy())
    np.testing.assert_allclose(xj.numpy(), x0.numpy(), rtol=1e-5, atol=1e-6)
    assert np.abs(a @ xj.numpy() - b).max() < 1e-3


def test_inverter_cholesky_refine_ignores_upper_junk():
    """Inverter(method='cholesky', refine_iters=2) polishes against the
    symmetrized lower triangle: junk above the diagonal gives the inverse
    of the lower triangle alone bit for bit, within the JAX test's
    1e-5 / 1e-7 of the clean one, residual < 1e-6, and within 1e-5 of the
    JAX Inverter's."""
    n = 80
    a = spd_matrix(n, seed=17)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 555.0
    inv = tmi.Inverter(dtype="float32", method="cholesky", refine_iters=2,
                       device="cpu")
    x0, ok0 = inv.inverse(a)
    xl, okl = inv.inverse(np.tril(a))
    xj, okj = inv.inverse(junk)
    assert bool(ok0) and bool(okl) and bool(okj)
    np.testing.assert_array_equal(xj.numpy(), xl.numpy())
    np.testing.assert_allclose(xj.numpy(), x0.numpy(), rtol=1e-5, atol=1e-7)
    assert relative_residual(a, xj.numpy()) < 1e-6
    want, _ = jmi.Inverter(dtype="float32", method="cholesky",
                           refine_iters=2).inverse(junk)
    assert _frob(xj, want) <= 1e-5


@pytest.mark.parametrize("n", [1, 64, 200, 1000, 1200, 4096, 8192])
def test_potri_effective_flops_equal(n, monkeypatch):
    """The flop model equals the JAX one for both product schedules."""
    for two_d in (False, True):
        monkeypatch.setattr(jchol, "_POTRI_PRODUCT_2D", two_d)
        monkeypatch.setattr(tchol, "_POTRI_PRODUCT_2D", two_d)
        for bs in (64, 256):
            assert (tchol.potri_effective_flops(n, block_size=bs)
                    == jchol.potri_effective_flops(n, block_size=bs))


def test_only_sharded_still_raises():
    a = _t(spd_matrix(32, seed=1))
    for method in ("auto", "spec", "fused", "blocked", "lu", "cholesky",
                   "ns"):
        _, ok = tmi.inverse(a, method=method)
        assert bool(ok), method
    with pytest.raises(NotImplementedError):
        tmi.inverse(a, method="sharded")
