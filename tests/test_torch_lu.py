"""Parity of the port's LU route (kernel K5 through its plain twin, K3 in
getrf, trtri, getri, solve, the determinant and the flop models) with the
JAX package, on the CPU.

Tolerances, each with its reason:
- K5: bit-identical with ok equal (the twin rounds the trailing update
  once, as XLA's CPU code contracts it, and divides as IEEE does).
- Permutations: identical (standard_normal inputs, well-separated pivots).
- fp32 factors and inverses: within 1e-4 in max-abs relative difference
  (triangular solves and GEMMs sum in other orders; measured <= 6.4e-5).
- fp64: within 1e-10.
- Against numpy (slogdet, det, solve): 1e-9 relative in fp64, 1e-4 in
  fp32.
JAX calls with the Pallas kernels stay at m <= 384 (interpret mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gpu_matrix_inversion_tpu as jmi  # noqa: E402
import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu.ops import lu as jlu  # noqa: E402
from gpu_matrix_inversion_tpu.ops import refine as jrefine  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import lu as tlu  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import refine as trefine  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,case", [(32, "random"), (64, "random"),
                                    (32, "zero_pivot"), (32, "nan")])
def test_small_lu_twin_matches_jax(b, case):
    """K5's twin against ``_small_lu``: bit-identical, ok equal (false on
    a zero pivot and on NaN input)."""
    rng = np.random.default_rng(b)
    d = rng.standard_normal((b, b)).astype(np.float32)
    d += np.float32(b) * np.eye(b, dtype=np.float32)
    if case == "zero_pivot":
        d[3, 3] = 0.0
        d[3, :3] = 0.0
    elif case == "nan":
        d[9, 2] = np.nan
    with jax.enable_x64(False):
        want, want_ok = jlu._small_lu(jnp.asarray(d), interpret=True)
    got, ok = tlu.small_lu(_t(d))
    assert bool(ok) == bool(want_ok) == (case == "random")
    if case == "random":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,serves", [(1, True), (8, True), (40, True),
                                      (128, True), (0, False), (129, False),
                                      (256, False)])
def test_small_lu_block_limit(b, serves):
    """K5 keeps a block in registers, at most 128 x 128: the largest block
    getrf hands it at every size and dtype it serves."""
    if serves:
        tlu.check_small_lu_block(b)
    else:
        with pytest.raises(ValueError, match="1 to 128"):
            tlu.check_small_lu_block(b)


@pytest.mark.parametrize("n", [100, 4096, 8192, 16384, 20000, 40000])
def test_getrf_blocks_fit_k5(n):
    """getrf's block, as lu_factor_blocked derives it, even for a block
    size of 256 asked for, fits K5 wherever the kernels run."""
    from gpu_matrix_inversion_tpu_torch.ops.blocked import (
        _select_block_params)
    b, use_kernels, _ = _select_block_params(n, min(256, max(n, 8)),
                                             torch.float32, False)
    assert use_kernels and b <= tlu.K5_MAX_B


@pytest.mark.parametrize("group", ["2", "1", "default"])
def test_lu_factor_blocked_matches_jax(group, monkeypatch):
    """fp32 getrf through K3 and K5 at n = 200, b = 64 (m = 256, four
    panels): grouped two panels per group, the flat loop
    (MATINV_LU_GROUP=1), and the default group (one group of four)."""
    if group != "default":
        monkeypatch.setenv("MATINV_LU_GROUP", group)
    rng = np.random.default_rng(40)
    a = rng.standard_normal((200, 200)).astype(np.float32)
    want, wperm, wok = jlu.lu_factor_blocked(jnp.asarray(a), block_size=64)
    got, perm, ok = tlu.lu_factor_blocked(_t(a), block_size=64)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert bool(ok) == bool(wok) and bool(ok)
    assert _rel(got, want) <= 1e-4
    lo = np.tril(got.numpy().astype(np.float64), -1) + np.eye(200)
    up = np.triu(got.numpy().astype(np.float64))
    assert _rel(lo @ up, a[perm.numpy()]) <= 1e-5


def test_lu_factor_blocked_fp64_and_batch_match_jax():
    """fp64 runs the plain panel loop (n = 160, b = 64, padded to 192); a
    batch loops one matrix at a time."""
    rng = np.random.default_rng(41)
    a = rng.standard_normal((2, 160, 160))
    want, wperm, wok = jlu.lu_factor_blocked(jnp.asarray(a), block_size=64)
    got, perm, ok = tlu.lu_factor_blocked(_t(a), block_size=64)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert ok.tolist() == np.asarray(wok).tolist() == [True, True]
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("case", ["singular", "nan"])
def test_lu_flags_singular_and_nonfinite(case):
    """ok is false in both packages on an all-ones matrix and on NaN
    input, through getrf (K3 + K5), getri and the spec."""
    a = np.ones((136, 136), np.float32)
    if case == "nan":
        a = hollow_random_matrix(136, seed=42)
        a[7, 11] = np.nan
    _, _, wok = jlu.lu_factor_blocked(jnp.asarray(a), block_size=64)
    _, _, ok = tlu.lu_factor_blocked(_t(a), block_size=64)
    assert not bool(ok) and not bool(wok)
    assert not bool(tlu.lu_inverse_fast(_t(a))[1])
    small = a[:40, :40].astype(np.float64)
    assert (bool(tlu.lu_factor(_t(small))[2])
            == bool(jlu.lu_factor(jnp.asarray(small))[2]) is False)


def test_lu_spec_matches_jax():
    """The spec (lu_factor, lu_solve, lu_inverse, lu_solve_matrix) on an
    fp64 batch, with and without pivoting."""
    rng = np.random.default_rng(43)
    a = rng.standard_normal((2, 40, 40)) + 40 * np.eye(40)
    b = rng.standard_normal((2, 40, 3))
    for pivot in (True, False):
        want, wperm, wok = jlu.lu_factor(jnp.asarray(a), pivot=pivot)
        got, perm, ok = tlu.lu_factor(_t(a), pivot=pivot)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
        assert ok.tolist() == np.asarray(wok).tolist() == [True, True]
        assert _rel(got, want) <= 1e-10
    x, ok = tlu.lu_solve(got, perm, _t(b))
    assert _rel(x, jlu.lu_solve(want, wperm, jnp.asarray(b))[0]) <= 1e-10
    assert _rel(tlu.lu_inverse(_t(a))[0], jlu.lu_inverse(jnp.asarray(a))[0]
                ) <= 1e-10
    x, ok = tlu.lu_solve_matrix(_t(a), _t(b))
    assert bool(ok.all())
    assert _rel(x, np.linalg.solve(a, b)) <= 1e-10


def test_lu_solve_fast_matches_jax():
    """getrs through the triangular solves, a batch of two with three
    right-hand sides each."""
    rng = np.random.default_rng(44)
    a = rng.standard_normal((2, 96, 96))
    b = rng.standard_normal((2, 96, 3))
    lu, perm, _ = jlu.lu_factor(jnp.asarray(a))
    want, wok = jlu.lu_solve_fast(lu, perm, jnp.asarray(b))
    got, ok = tlu.lu_solve_fast(_t(np.asarray(lu)), _t(np.asarray(perm)),
                                _t(b))
    assert ok.tolist() == np.asarray(wok).tolist() == [True, True]
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("canvas", [True, False])
@pytest.mark.parametrize("lower,unit", [(True, True), (False, False)])
def test_invert_triangular_matches_jax(lower, unit, canvas):
    """trtri at n = 1100 (base block 144, three bisection levels, the
    last with chunked cross products at s = 576), canvas and batched
    assembly, both triangles."""
    n = 1100
    rng = np.random.default_rng(45)
    t = rng.standard_normal((n, n)) / 30 + 2 * np.eye(n)
    want, wok = jlu.invert_triangular(jnp.asarray(t), lower=lower,
                                      unit_diagonal=unit, canvas=canvas)
    got, ok = tmi.invert_triangular(_t(t), lower=lower, unit_diagonal=unit,
                                    canvas=canvas)
    assert bool(ok) and bool(wok)
    assert _rel(got, want) <= 1e-10
    tri = np.tril(t) if lower else np.triu(t)
    if unit:
        np.fill_diagonal(tri, 1.0)
    np.testing.assert_allclose(tri @ got.numpy(), np.eye(n), atol=1e-10)
    zero = t.copy()
    zero[5, 5] = 0.0
    assert bool(tmi.invert_triangular(_t(zero), lower=lower)[1]) is False


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("triangular", [False, True])
def test_getri_product_matches_jax(triangular, transposed):
    """Both product schedules (column chunks; the double-triangular
    tiles), plain and with ``left`` transposed, at n = 300 with chunks of
    128 (a ragged tail)."""
    rng = np.random.default_rng(46)
    left = np.triu(rng.standard_normal((300, 300)))
    if transposed:
        left = left.T.copy()
    linv = np.tril(rng.standard_normal((300, 300)))
    kw = dict(chunk=128, rchunk=128, left_transposed=transposed,
              left_triangular=triangular)
    want = jlu._getri_product(jnp.asarray(left), jnp.asarray(linv), **kw)
    got = tlu._getri_product(_t(left), _t(linv), **kw)
    assert _rel(got, want) <= 1e-12
    dense = (left.T if transposed else left) @ linv
    assert _rel(got, dense) <= 1e-12


@pytest.mark.parametrize("route", ["trtri", "solve"])
def test_lu_inverse_fast_matches_jax(route, monkeypatch):
    """fp32 getri at n = 300 (b = 128: K3 and K5 in getrf) through the
    trtri composition and the MATINV_GETRI_ROUTE=solve route."""
    monkeypatch.setenv("MATINV_GETRI_ROUTE", route)
    a = hollow_random_matrix(300, seed=47)
    want, wok = jlu.lu_inverse_fast(jnp.asarray(a))
    got, ok = tlu.lu_inverse_fast(_t(a))
    assert bool(ok) and bool(wok)
    assert _rel(got, want) <= 1e-4
    assert relative_residual(a, got.numpy()) < 1e-5


def test_lu_inverse_chunked_and_inverse_method():
    """The chunked identity solve equals the one-shot solve (chunk 48 at
    n = 100, a ragged tail); ``inverse(method="lu")`` takes the spec below
    n = 256 and getri from it, like the JAX package."""
    a = hollow_random_matrix(100, seed=48, dtype=np.float64)
    lu, perm, _ = tlu.lu_factor_blocked(_t(a))
    inv, ok = tlu._lu_inverse_chunked(lu, perm, chunk=48)
    one, _ = tlu.lu_solve_fast(lu, perm, torch.eye(100, dtype=torch.float64))
    assert bool(ok) and _rel(inv, one) <= 1e-12
    for n in (100, 300):
        x = hollow_random_matrix(n, seed=n, dtype=np.float64)
        got, ok = tmi.inverse(_t(x), method="lu")
        want, wok = jmi.inverse(jnp.asarray(x), method="lu")
        assert bool(ok) and bool(wok) and _rel(got, want) <= 1e-10


@pytest.mark.parametrize("method,n,dtype,refine", [
    ("auto", 600, np.float64, 0),    # n >= 512: the LU route
    ("lu", 300, np.float32, 1),      # K3 + K5, one refinement step
    ("lu", 100, np.float64, 1),      # the spec below n = 256
    ("auto", 100, np.float64, 1),    # the inverse, then a GEMM
])
def test_solve_matches_jax(method, n, dtype, refine):
    rng = np.random.default_rng(49)
    a = hollow_random_matrix(n, seed=n + 1, dtype=dtype)
    b = rng.standard_normal((n, 4)).astype(dtype)
    want, wok = jmi.solve(jnp.asarray(a), jnp.asarray(b), method=method,
                          refine_iters=refine)
    got, ok = tmi.solve(_t(a), _t(b), method=method, refine_iters=refine)
    assert bool(ok) and bool(wok)
    tol = 1e-4 if dtype == np.float32 else 1e-9
    assert _rel(got, want) <= tol
    assert _rel(got, np.linalg.solve(a.astype(np.float64), b)) <= tol


def test_solve_routes_and_vector_rhs(monkeypatch):
    """``auto`` takes the LU route from n = 512 (solver.py:186) and the
    inverse below; a vector right-hand side comes back a vector, on the
    ``method="cholesky"`` route too."""
    calls = []
    real = tlu.lu_factor_blocked
    monkeypatch.setattr(tlu, "lu_factor_blocked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for n, lu_route in ((512, True), (511, False)):
        calls.clear()
        a = hollow_random_matrix(n, seed=3, dtype=np.float64)
        b = np.random.default_rng(n).standard_normal(n)
        x, ok = tmi.solve(_t(a), _t(b))
        assert x.shape == (n,) and bool(ok)
        assert bool(calls) == lu_route
        assert _rel(x, np.linalg.solve(a, b)) <= 1e-9
    x, ok = tmi.solve(4 * torch.eye(8), torch.ones(8), method="cholesky")
    assert bool(ok) and torch.equal(x, torch.full((8,), 0.25))


@pytest.mark.parametrize("n,dtype", [(600, "float64"), (20000, "float32")])
def test_solve_lu_gate_routes_like_jax(n, dtype, monkeypatch):
    """``solve(method="auto")`` takes the LU route (blocked getrf, then
    getrs) at fp64 n = 600 and fp32 n = 20000 in both packages. Shapes
    only: the factor and the solve are stubbed to record their calls, the
    port runs on meta tensors and the JAX package under ``eval_shape``."""
    calls = {"jax": [], "torch": []}

    def factor(pkg, mod):
        def stub(a, **kw):
            calls[pkg].append("getrf")
            if pkg == "jax":
                return a, jnp.zeros(n, jnp.int32), jnp.asarray(True)
            return (a, torch.empty(n, dtype=torch.int32, device=a.device),
                    torch.ones((), dtype=torch.bool, device=a.device))
        monkeypatch.setattr(mod, "lu_factor_blocked", stub)

    def getrs(pkg, mod):
        def stub(lu, perm, b):
            calls[pkg].append("getrs")
            return b, (lu[0, 0] == lu[0, 0])
        monkeypatch.setattr(mod, "lu_solve_fast", stub)

    for pkg, mod in (("jax", jlu), ("torch", tlu)):
        factor(pkg, mod)
        getrs(pkg, mod)
    a = torch.empty((n, n), dtype=getattr(torch, dtype), device="meta")
    x, ok = tmi.solve(a, torch.empty((n, 4), dtype=a.dtype, device="meta"))
    jx, jok = jax.eval_shape(jmi.solve,
                             jax.ShapeDtypeStruct((n, n), getattr(jnp, dtype)),
                             jax.ShapeDtypeStruct((n, 4), getattr(jnp, dtype)))
    assert calls["torch"] == calls["jax"] == ["getrf", "getrs"]
    assert tuple(x.shape) == jx.shape == (n, 4) and ok.shape == jok.shape


def test_refine_solve_matches_jax():
    """One refinement step of an fp32 factor with float64 residuals."""
    a = hollow_random_matrix(64, seed=50)
    b = np.random.default_rng(50).standard_normal((64, 2)).astype(np.float32)
    lu, perm, _ = jlu.lu_factor(jnp.asarray(a))
    x0, _ = jlu.lu_solve(lu, perm, jnp.asarray(b))
    want = jrefine.refine_solve(jnp.asarray(a), jnp.asarray(b), x0, lu, perm,
                                iters=1, residual_dtype=jnp.float64)
    got = trefine.refine_solve(_t(a), _t(b), _t(np.asarray(x0)),
                               _t(np.asarray(lu)), _t(np.asarray(perm)),
                               iters=1, residual_dtype=torch.float64)
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("n,dtype", [(100, np.float64), (300, np.float64),
                                     (300, np.float32)])
def test_slogdet_and_det_match_numpy(n, dtype):
    """The spec below n = 256, getrf from it (K3 + K5 in fp32), against
    numpy.linalg and the JAX package; an exactly singular input gives ok
    False, and in fp64 sign 0 and logabsdet -inf (in fp32 the kernel
    path's zero pivots leave non-finite values, in both packages)."""
    a = hollow_random_matrix(n, seed=n, dtype=dtype) / 50
    sign, logabs, ok = tmi.slogdet(_t(a))
    wsign, wlog = np.linalg.slogdet(a.astype(np.float64))
    jsign, jlog, _ = jmi.slogdet(jnp.asarray(a))
    tol = 1e-4 if dtype == np.float32 else 1e-9
    assert bool(ok) and float(sign) == wsign == float(jsign)
    assert abs(float(logabs) - wlog) <= tol * abs(wlog)
    assert abs(float(logabs) - float(jlog)) <= tol * abs(wlog)
    d, ok = tmi.det(_t(a[:40, :40]))
    assert _rel(d, np.linalg.det(a[:40, :40].astype(np.float64))) <= tol
    sign, logabs, ok = tmi.slogdet(_t(np.ones((n, n), dtype)))
    assert not bool(ok)
    if dtype == np.float64:
        assert float(sign) == 0.0 and float(logabs) == -np.inf


def test_cond_estimate_matches_numpy():
    """Power iteration on a spectrum with gaps (10, 1, ..., 1, 0.1): the
    estimate converges to cond_2 = 100 from either package's start
    vector."""
    rng = np.random.default_rng(51)
    q1, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    q2, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    s = np.ones(32)
    s[0], s[-1] = 10.0, 0.1
    a = (q1 * s) @ q2.T
    inv = np.linalg.inv(a)
    got = float(tlu.cond_estimate(_t(a), _t(inv)))
    want = float(jlu.cond_estimate(jnp.asarray(a), jnp.asarray(inv)))
    assert abs(got - 100.0) <= 1e-3 and abs(want - 100.0) <= 1e-3


@pytest.mark.parametrize("n", [100, 256, 1000, 2048, 4096, 5000, 11000,
                               16384, 20000])
def test_flop_models_match_jax(n):
    assert tlu.getrf_effective_flops(n) == jlu.getrf_effective_flops(n)
    assert tlu.getri_effective_flops(n) == jlu.getri_effective_flops(n)
    for b in (None, 128, 256):
        assert (tlu._trtri_effective_flops(n, b)
                == jlu._trtri_effective_flops(n, b))
    for tri in (False, True):
        assert (tlu._getri_product_flops(n, left_triangular=tri)
                == jlu._getri_product_flops(n, left_triangular=tri))
