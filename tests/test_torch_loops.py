"""The FP64 tier's device-side loops on the CPU: L1's twin (the plain
Gauss-Jordan loop) and L2's twin (the logical panel) against the JAX
package, the rounding the kernels follow, the wrappers' dispatch, the
kernels' geometry and how often each route calls the loops.

Tolerances, each with its reason:
- The Gauss-Jordan loop, step by step: the (n, 2n) state after every step
  within 1e-12 (fp64) and 1e-5 (fp32) of the JAX one, relative to its
  largest entry. A different pivot puts other rows in place and misses
  that by orders of magnitude, so the pivot order is identical; the
  values differ in the last bits because XLA's CPU code contracts
  x - f * v into an FMA where the port rounds twice. ok equal on every
  member, a singular and a NaN one among them.
- The rounding pin: bit for bit (it is the point of the test).
"""

import functools
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpu_matrix_inversion_tpu.ops import gauss_jordan as jgj  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models import solver  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan as tgj  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils import cuda_build  # noqa: E402


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _jax_step(n: int, pivot: bool):
    return jax.jit(functools.partial(jgj._gj_step, n=n, pivot=pivot))


def _members(bsz: int, n: int, dtype, pivot: bool) -> np.ndarray:
    """A regular member first; in a batch of 3 a singular member (a zero
    row, whose pivot is exactly zero under either rounding) and one holding
    a NaN. Each member is standard normal plus 4 sqrt(n) on the diagonal,
    its rows shuffled when pivoting: a condition number of a few units
    (fp32's tolerance holds at n = 64), pivots that must be searched for."""
    rng = np.random.default_rng(100 * n + bsz)
    a = rng.standard_normal((bsz, n, n)) + 4 * np.sqrt(n) * np.eye(n)
    if pivot:
        a = a[:, rng.permutation(n)]
    if bsz == 3:
        a[1, 1] = 0.0
        a[2, n // 2, n // 3] = np.nan
    return a.astype(dtype)


@pytest.mark.parametrize("n", [8, 37, 64])
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gauss_jordan_twin_matches_jax(dtype, pivot, bsz, n):
    """The plain loop against the JAX package's, step by step on the
    regular member, ok on every member."""
    a = _members(bsz, n, dtype, pivot)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    inv, ok = tgj._gauss_jordan_aug(torch.from_numpy(a), pivot=pivot)
    for i in range(bsz):
        want_inv, want_ok = jgj._gauss_jordan_aug(jnp.asarray(a[i]),
                                                  pivot=pivot)
        assert bool(ok[i]) == bool(want_ok)
        if i == 0:
            assert bool(ok[i])
            assert _rel(inv[i].numpy(), want_inv) <= tol
    # Step by step on the regular member: the same pivot every step.
    aug_t = tgj._augment(torch.from_numpy(a[:1]))
    aug_j = jnp.asarray(aug_t[0].numpy())
    ok_t = torch.ones(1, dtype=torch.bool)
    ok_j = jnp.bool_(True)
    step = _jax_step(n, pivot)
    for r in range(n):
        tgj._gj_step(aug_t, r, ok_t, pivot=pivot)
        aug_j, ok_j = step(jnp.int32(r), (aug_j, ok_j))
        assert _rel(aug_t[0].numpy(), aug_j) <= tol, f"step {r}"
    assert bool(ok_t[0]) and bool(ok_j)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_rounds_multiply_then_subtract(dtype):
    """x - f * v in the twin rounds the product, then the difference, as
    L1 and L2 must (__dmul_rn then __dsub_rn): on [[2, v], [f, x]] with
    f = v / 2 = 1 + 2^-k the first step leaves x - f * v / 2, where an FMA
    (one rounding) gives another value. The whole inverse is held bit for
    bit to the two-rounding sequence computed by hand in numpy."""
    k = 30 if dtype == np.float64 else 12
    f = dtype(1 + 2.0 ** -k)
    v = dtype(2 * (1 + 2.0 ** -k))
    a = np.array([[2, v], [f, 1]], dtype=dtype)
    inv, ok = tgj._gauss_jordan_aug(torch.from_numpy(a[None]), pivot=True)
    # By hand, each operation rounded alone (numpy never contracts).
    one, zero = dtype(1), dtype(0)
    nr0 = np.array([a[0, 0], a[0, 1], one, zero], dtype) / a[0, 0]
    row1 = np.array([a[1, 0], a[1, 1], zero, one], dtype) - a[1, 0] * nr0
    x1 = row1[1]
    fused = float(Fraction(float(a[1, 1]))
                  - Fraction(float(a[1, 0])) * Fraction(float(nr0[1])))
    assert dtype(fused) != x1          # the input separates the two roundings
    nr1 = row1 / x1
    row0 = nr0 - nr0[1] * nr1
    want = np.stack([row0[2:], nr1[2:]])
    assert bool(ok[0])
    assert inv[0].numpy().tobytes() == want.astype(dtype).tobytes()


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    """A CPU tensor runs each wrapper's plain twin, without the library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)
    gj0 = tgj.gauss_jordan_twin.calls
    lp0 = tblocked.logical_panel_twin.calls
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 16, 16)))
    inv, ok = tgj._gauss_jordan_aug(a, pivot=True)
    assert bool(ok.all())
    strip = torch.from_numpy(rng.standard_normal((64, 8)))
    used = torch.zeros(64, dtype=torch.int32)
    piv, ok = tblocked._panel_pivots_logical(strip, used, 0, b=8, pivot=True)
    assert bool(ok) and piv.shape == (8,)
    assert tgj.gauss_jordan_twin.calls == gj0 + 1
    assert tblocked.logical_panel_twin.calls == lp0 + 1
    assert tgj._gauss_jordan_aug.launches == 0
    assert tblocked._panel_pivots_logical.launches == 0


@pytest.mark.parametrize("n, batch, itemsize, branch, ctas, shared", [
    (256, 1, 8, "cluster", 8, True),      # the FP64 tier's pivot block
    (256, 64, 8, "cluster", 4, True),     # the (64, 256^2) batch
    (511, 1, 8, "cluster", 16, True),     # spec's largest FP64 n
    (8, 64, 8, "cluster", 1, True),       # small n, a CTA a matrix
    (512, 1, 8, "grid", 16, True),
    (1000, 1, 8, "grid", 39, True),
    (640, 1, 4, "grid", 20, True),
    (2000, 1, 8, "grid", 125, False),     # rows past the grid's shared memory
])
def test_l1_geometry(n, batch, itemsize, branch, ctas, shared):
    """L1's branch, CTAs and shared memory at the routes' shapes: every CTA
    holds rows and fits one block's shared memory."""
    geo = tgj.loop_geometry(n, batch, itemsize)
    assert (geo.branch, geo.ctas, geo.rows_shared) == (branch, ctas, shared)
    assert (geo.ctas - 1) * geo.rows < n <= geo.ctas * geo.rows
    assert geo.smem <= tgj.SHARED_BYTES
    assert geo.smem == tgj.loop_smem(
        geo.rows, n, 3 * n, itemsize, rows_shared=shared,
        props_shared=branch == "cluster")


@pytest.mark.parametrize("m, b, itemsize, ctas, rows, shared", [
    (8192, 256, 8, 131, 63, True),        # FP64 8192^2's panels
    (4096, 256, 8, 128, 32, True),        # no-pivot FP64 4096^2
    (16384, 256, 8, 132, 125, False),     # past the grid's shared memory
    (65600, 32, 4, 132, 497, True),       # fp32 past m = 65536
    (512, 64, 8, 16, 32, True),
])
def test_l2_geometry(m, b, itemsize, ctas, rows, shared):
    """L2's persistent grid at the logical tier's shapes."""
    geo = tblocked.logical_geometry(m, b, itemsize)
    assert (geo.branch, geo.ctas, geo.rows, geo.rows_shared) == (
        "grid", ctas, rows, shared)
    assert (geo.ctas - 1) * geo.rows < m
    assert geo.smem <= tgj.SHARED_BYTES


@pytest.mark.parametrize("pivot", [True, False])
def test_fp64_routes_call_the_loops(pivot, monkeypatch):
    """FP64 n = 600 (b = 256, three panels): with pivoting the f32-search
    tier inverts three pivot blocks and runs no logical panel; without it
    the logical tier runs the logical panel and the block inverse once a
    panel. The result inverts the input."""
    calls = {"gj": 0, "lp": 0}
    real_gj = tblocked._gauss_jordan_aug
    real_lp = tblocked._panel_pivots_logical

    def gj(*args, **kw):
        calls["gj"] += 1
        return real_gj(*args, **kw)

    def lp(*args, **kw):
        calls["lp"] += 1
        return real_lp(*args, **kw)

    monkeypatch.setattr(tblocked, "_gauss_jordan_aug", gj)
    monkeypatch.setattr(tblocked, "_panel_pivots_logical", lp)
    n = 600
    rng = np.random.default_rng(600)
    a = rng.standard_normal((n, n)) + (0 if pivot else 2 * n) * np.eye(n)
    inv, ok = solver.inverse(torch.from_numpy(a), pivot=pivot)
    assert calls == {"gj": 3, "lp": 0 if pivot else 3}
    assert bool(ok)
    resid = np.abs(a @ inv.numpy() - np.eye(n)).max()
    assert resid < 1e-10
