"""The LU module's device-side loops on the CPU: the twins of L4 (the spec
getrf), L5 (the spec getrs) and L3 (the blocked getrf's panel) against the
JAX package's loops, the rounding the kernels follow, the wrappers'
dispatch, the kernels' geometry and how often each user path calls the
loops.

Tolerances, each with its reason:
- Pivot order, perm and the panel's pivot rows and mask: identical (a
  different pivot puts other rows in place and misses the values by
  orders of magnitude).
- Values: within 1e-12 (fp64) and 1e-5 (fp32) of the JAX ones, relative
  to their largest entry: XLA's CPU code contracts x - f * v into an FMA
  where the twins round twice, so the last bits differ.
- ok: equal on every member, a singular and a NaN one among them.
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

import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu.ops import lu as jlu  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan as tgj  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.ops import lu as tlu  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import refine as trefine  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils import cuda_build  # noqa: E402


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _tol(dtype) -> float:
    return 1e-12 if dtype == np.float64 else 1e-5


@functools.lru_cache(maxsize=None)
def _jax_factor(pivot: bool):
    return jax.jit(functools.partial(jlu._lu_factor_2d, pivot=pivot))


_jax_solve = jax.jit(jlu._lu_solve_2d)


@functools.lru_cache(maxsize=None)
def _jax_panel(m: int, b: int, kb: int, pivot: bool):
    return jax.jit(functools.partial(jlu._lu_panel, kb=kb, m=m, b=b,
                                     pivot=pivot))


def _members(n: int, dtype, pivot: bool) -> np.ndarray:
    """Three members: a regular one (standard normal plus 4 sqrt(n) on the
    diagonal, its rows shuffled when pivoting, so that pivots must be
    searched for and fp32's tolerance holds), a singular one (a zero row,
    whose pivot is exactly zero under either rounding) and one holding a
    NaN."""
    rng = np.random.default_rng(n + pivot)
    a = rng.standard_normal((3, n, n)) + 4 * np.sqrt(n) * np.eye(n)
    if pivot:
        a = a[:, rng.permutation(n)]
    a[1, 1] = 0.0
    a[2, n // 2, n // 3] = np.nan
    return a.astype(dtype)


@pytest.mark.parametrize("n", [48, 96, 130])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_factor_twin_matches_jax(dtype, pivot, n):
    """L4's twin against ``_lu_factor_2d``: perm identical and the factor
    within tolerance on the regular member, ok on every member."""
    a = _members(n, dtype, pivot)
    fac, perm, ok = tlu._lu_factor_batched(torch.from_numpy(a), pivot=pivot)
    assert perm.dtype == torch.long
    for i in range(3):
        want_lu, want_perm, want_ok = _jax_factor(pivot)(jnp.asarray(a[i]))
        assert bool(ok[i]) == bool(want_ok) == (i == 0)
        if i == 0:
            assert np.array_equal(perm[i].numpy(), np.asarray(want_perm))
            assert _rel(fac[i].numpy(), want_lu) <= _tol(dtype)


@pytest.mark.parametrize("k", [1, 16, "n"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_solve_twin_matches_jax(dtype, k):
    """L5's twin against ``_lu_solve_2d`` on the same packed factors (the
    twin's, of the members above at n = 96): x within tolerance on the
    regular member, ok on every member."""
    n = 96
    k = n if k == "n" else k
    a = _members(n, dtype, True)
    fac, perm, _ = tlu.lu_factor_twin(torch.from_numpy(a), pivot=True)
    b = np.random.default_rng(k).standard_normal((3, n, k)).astype(dtype)
    x, ok = tlu._lu_solve_batched(fac, perm, torch.from_numpy(b))
    for i in range(3):
        want_x, want_ok = _jax_solve(jnp.asarray(fac[i].numpy()),
                                     jnp.asarray(perm[i].numpy()),
                                     jnp.asarray(b[i]))
        assert bool(ok[i]) == bool(want_ok) == (i == 0)
        if i == 0:
            assert _rel(x[i].numpy(), want_x) <= _tol(dtype)


@pytest.mark.parametrize("lu_dtype, b_dtype", [
    (torch.float32, torch.float64), (torch.float64, torch.float32)])
def test_lu_solve_twin_takes_b_in_another_dtype(lu_dtype, b_dtype):
    """The twin (the CPU's path) takes b in another dtype than the factor's
    and returns x in b's. Where b is the wider, its bits are those of the
    solve run wholly in b's dtype, which is what L5 computes on the card
    (ROADMAP Queue 3); where b is the narrower, the twin rounds y into b's
    dtype at every step and L5 rounds x once, so only ok is equal and x
    agrees to b's precision."""
    n = 96
    a = _members(n, np.float64, True)
    fac, perm, _ = tlu.lu_factor_twin(torch.from_numpy(a), pivot=True)
    fac = fac.to(lu_dtype)
    b = torch.from_numpy(
        np.random.default_rng(5).standard_normal((3, n, 4))).to(b_dtype)
    x, ok = tlu._lu_solve_batched(fac, perm, b)
    wide = torch.promote_types(lu_dtype, b_dtype)
    x_wide, ok_wide = tlu.lu_solve_twin(fac.to(wide), perm, b.to(wide))
    assert x.dtype == b_dtype
    assert torch.equal(ok, ok_wide)
    if b_dtype == wide:
        assert torch.equal(x.view(torch.int64), x_wide.view(torch.int64))
    else:
        assert _rel(x[0].numpy(), x_wide[0].numpy()) <= _tol(np.float32)


@pytest.mark.parametrize("m, b", [(256, 32), (520, 64)])
@pytest.mark.parametrize("pivot", [True, False])
def test_lu_panel_twin_matches_jax(m, b, pivot):
    """L3's twin against the JAX ``_lu_panel`` on an fp64 strip with prior
    used rows (a random third with pivoting; without it the rows above kb,
    as the blocked loop leaves them): pivot rows, mask and ok identical,
    the panel within 1e-12."""
    rng = np.random.default_rng(m + b + pivot)
    strip = rng.standard_normal((m, b))
    used = np.zeros(m, np.int32)
    if pivot:
        kb = 0
        used[rng.permutation(m)[:m // 3]] = 1
    else:
        kb = 2 * b
        used[:kb] = 1
        strip += 4 * b * (np.arange(m)[:, None] == np.arange(b) + kb)
    w, piv, used_out, ok = tlu._lu_panel(
        torch.from_numpy(strip), torch.from_numpy(used), kb, b=b, pivot=pivot)
    want_w, want_piv, want_used, want_ok = _jax_panel(m, b, kb, pivot)(
        jnp.asarray(strip), jnp.asarray(used.astype(np.float32)[:, None]))
    assert np.array_equal(piv.numpy(), np.asarray(want_piv))
    assert np.array_equal(used_out.numpy(), np.asarray(want_used)[:, 0])
    assert used_out.dtype == torch.int32
    assert bool(ok) == bool(want_ok)
    assert _rel(w.numpy(), want_w) <= 1e-12


def _fused(x, f, v) -> float:
    """x - f * v rounded once (an FMA)."""
    return float(Fraction(float(x)) - Fraction(float(f)) * Fraction(float(v)))


@pytest.mark.parametrize("loop", ["getrf", "getrs", "panel"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twins_round_multiply_then_subtract(dtype, loop):
    """Each twin's x - f * v rounds the product, then the difference, as
    L3, L4 and L5 must (__dmul_rn then __dsub_rn): with f = v = 1 + 2^-k
    the element 1 - f * v lands between the two roundings' values (the
    factor's and the panel's row 0 = [8, 2 v] over row 1 = [4 f, 1], so
    the multiplier f / 2 times 2 v is f v, and row 0 stays the pivot). Held
    bit for bit to the two-rounding value computed in numpy, which never
    contracts."""
    k = 30 if dtype == np.float64 else 12
    f = dtype(1 + 2.0 ** -k)
    v = dtype(1 + 2.0 ** -k)
    one = dtype(1)
    want = one - f * v
    assert dtype(_fused(one, f, v)) != want   # the input separates them
    if loop == "getrf":
        a = np.array([[[8, 2 * v], [4 * f, 1]]], dtype)
        got = tlu._lu_factor_batched(torch.from_numpy(a), pivot=True)[0][
            0, 1, 1]
    elif loop == "getrs":
        fac = np.array([[[4, 0], [f, 1]]], dtype)
        rhs = np.array([[[v], [1]]], dtype)
        got = tlu._lu_solve_batched(torch.from_numpy(fac),
                                    torch.tensor([[0, 1]]),
                                    torch.from_numpy(rhs))[0][0, 1, 0]
    else:
        strip = np.array([[8, 2 * v], [4 * f, 1]], dtype)
        got = tlu._lu_panel(torch.from_numpy(strip),
                            torch.zeros(2, dtype=torch.int32), 0, b=2,
                            pivot=True)[0][1, 1]
    assert got.numpy().tobytes() == want.tobytes()


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    """A CPU tensor runs each wrapper's plain twin, without the library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)
    twins = (tlu.lu_factor_twin, tlu.lu_solve_twin, tlu.lu_panel_twin)
    before = [t.calls for t in twins]
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 16, 16)))
    fac, perm, ok = tlu._lu_factor_batched(a, pivot=True)
    x, ok_s = tlu._lu_solve_batched(fac, perm, torch.ones(2, 16, 3,
                                                          dtype=a.dtype))
    strip = torch.from_numpy(rng.standard_normal((64, 8)))
    w, piv, used, ok_p = tlu._lu_panel(strip, torch.zeros(64,
                                                          dtype=torch.int32),
                                       0, b=8, pivot=True)
    assert bool(ok.all()) and bool(ok_s.all()) and bool(ok_p)
    assert [t.calls for t in twins] == [c + 1 for c in before]
    assert (tlu._lu_factor_batched.launches == tlu._lu_solve_batched.launches
            == tlu._lu_panel.launches == 0)


@pytest.mark.parametrize("batch, k, kc", [
    (1, 16, 1),          # solve(..., refine_iters=2): 16 CTAs
    (1, 4096, 16),       # lu_inverse_refined's identity: 256 CTAs
    (64, 128, 16),       # inverse(method="lu") on a (64, 128^2) batch
    (1, 1, 1),           # a vector right-hand side
    (4, 100, 2),         # 200 CTAs of 2 columns
])
def test_l5_geometry(batch, k, kc):
    """L5's columns a CTA: as many as keep a CTA on every SM, to 16."""
    assert tlu.lu_solve_geometry(batch, k) == kc
    tiles = -(-k // kc)
    assert batch * tiles >= min(tgj.H100_SMS, batch * k) or kc == 16


@pytest.mark.parametrize("batch, n, k, itemsize, cluster, kc, ctas", [
    (1, 4096, 4096, 4, 16, 64, 1024),   # lu_inverse_refined 4096^2
    (1, 4096, 16, 4, 16, 64, 16),       # solve(..., refine_iters=2)
    (64, 128, 128, 4, 2, 64, 256),      # inverse(method="lu") on a batch
    (1, 4096, 4096, 8, 16, 32, 2048),   # fp64 getri: 32 columns a tile
    (16, 1024, 1024, 4, 4, 64, 1024),   # many tiles: clusters of 4
    (1, 512, 1, 4, 16, 64, 16),         # the smallest n a lone solve takes
    (1, 11776, 1, 4, 16, 64, 16),       # the largest n a cluster holds
    (1, 11777, 1, 4, 0, 1, 1),          # past it: the per-column path
    (1, 16384, 16, 4, 0, 1, 16),
    (1, 200, 1, 8, 0, 1, 1),            # small n: the per-column path
    (3, 100, 5, 8, 0, 1, 15),
    (8, 256, 256, 4, 0, 8, 256),        # small n, under 2 CTAs an SM
])
def test_l5_plan(batch, n, k, itemsize, cluster, kc, ctas):
    """L5's path by shape: the cluster path where the CTA's rows fit one
    block's shared memory and n >= 512 or the batch fills the card (a
    cluster of the largest power of two up to 16 and the count of 32-row
    blocks, halved while CTAs outnumber two an SM, a tile of 256 bytes of
    columns); else the per-column path of lu_solve_geometry."""
    plan = tlu.lu_solve_plan(batch, n, k, itemsize)
    assert (plan.cluster, plan.kc, plan.ctas) == (cluster, kc, ctas)
    if plan.cluster:
        assert plan.smem == tlu.lu_solve_smem(n, cluster, itemsize)
        assert plan.smem <= tgj.SHARED_BYTES
        assert kc * itemsize == tlu.LU_SOLVE_TILE_BYTES
    else:
        assert (tlu.lu_solve_smem(n, 16, itemsize) > tgj.SHARED_BYTES
                or n < tlu.LU_SOLVE_CLUSTER_MIN_N)
        assert kc == tlu.lu_solve_geometry(batch, k)


@pytest.mark.parametrize("n, batch, itemsize, branch, ctas, shared", [
    (128, 64, 4, "cluster", 2, True),     # inverse(method="lu") batches
    (200, 1, 8, "cluster", 8, True),
    (130, 1, 4, "cluster", 8, True),
    (600, 4, 8, "grid", 19, True),
    (4096, 1, 4, "grid", 128, False),     # lu_inverse_refined at 4096^2
])
def test_l4_geometry(n, batch, itemsize, branch, ctas, shared):
    """L1's geometry, which L4's cluster branch runs on to n = 511 (past
    it L4 takes lu_factor_plan's blocked path): every CTA holds rows and
    fits one block's shared memory."""
    geo = tgj.loop_geometry(n, batch, itemsize)
    assert (geo.branch, geo.ctas, geo.rows_shared) == (branch, ctas, shared)
    assert (geo.ctas - 1) * geo.rows < n <= geo.ctas * geo.rows
    assert geo.smem <= tgj.SHARED_BYTES


@pytest.mark.parametrize("batch, n, itemsize, path, ctas, rows", [
    (1, 4096, 4, "blocked", 128, 32),     # lu_inverse_refined at 4096^2
    (1, 512, 4, "blocked", 16, 32),       # the smallest blocked n
    (4, 600, 8, "blocked", 19, 32),
    (1, 1000, 4, "blocked", 32, 32),
    (1, 16000, 8, "blocked", 132, 122),   # past a CTA an SM: more rows
    (1, 16720, 8, "blocked", 132, 127),   # fp64's largest
    (1, 24912, 4, "blocked", 132, 189),   # fp32's largest
    (64, 128, 4, "cluster", 2, 64),       # inverse(method="lu") batches
    (1, 511, 8, "cluster", 16, 32),       # the cluster branch's largest
])
def test_l4_plan(batch, n, itemsize, path, ctas, rows):
    """L4's path by shape: L1's cluster geometry to n = 511, past it the
    blocked getrf on a grid of a CTA per 32 rows, at most one an SM, no
    CTA without rows, panels of 64 columns, its shared memory within one
    block's."""
    plan = tlu.lu_factor_plan(batch, n, itemsize)
    assert (plan.path, plan.ctas, plan.rows) == (path, ctas, rows)
    assert (plan.ctas - 1) * plan.rows < n <= plan.ctas * plan.rows
    assert plan.smem <= tgj.SHARED_BYTES
    if path == "blocked":
        assert plan.panel == tlu.LU_FACTOR_PANEL == 64
        assert plan.smem == tlu.lu_factor_smem(n, rows, 64, itemsize)
    else:
        geo = tgj.loop_geometry(n, batch, itemsize)
        assert (geo.branch, geo.ctas, geo.smem) == (path, ctas, plan.smem)


@pytest.mark.parametrize("n, itemsize", [(16721, 8), (24913, 4)])
def test_l4_plan_refuses_past_its_shared_memory(n, itemsize):
    """Past the largest order whose places fit a CTA's shared memory the
    plan raises, naming the bytes, and launches nothing."""
    with pytest.raises(ValueError, match="L4 at n="):
        tlu.lu_factor_plan(1, n, itemsize)


@pytest.mark.parametrize("m, b, itemsize, ctas, rows, shared", [
    (4096, 128, 8, 128, 32, True),        # FP64 getrf 4096^2's panels
    (1024, 128, 8, 32, 32, True),         # slogdet FP64 1024^2
    (16384, 256, 8, 132, 125, False),     # past the grid's shared memory
    (65600, 32, 4, 132, 497, True),       # fp32 past m = 65536
])
def test_l3_geometry(m, b, itemsize, ctas, rows, shared):
    """L3 runs on L2's persistent grid."""
    geo = tblocked.logical_geometry(m, b, itemsize)
    assert (geo.branch, geo.ctas, geo.rows, geo.rows_shared) == (
        "grid", ctas, rows, shared)
    assert geo.smem <= tgj.SHARED_BYTES


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls of the three wrappers (the twins run on the CPU)."""
    calls = {"L3": 0, "L4": 0, "L5": 0}
    for key, name in (("L3", "_lu_panel"), ("L4", "_lu_factor_batched"),
                      ("L5", "_lu_solve_batched")):
        real = getattr(tlu, name)

        def counted(*args, _key=key, _real=real, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tlu, name, counted)
    return calls


@pytest.mark.parametrize("path, n, dtype, want", [
    ("inverse lu", 128, torch.float32, {"L4": 1, "L5": 1}),
    ("solve lu", 128, torch.float32, {"L4": 1, "L5": 1}),
    ("solve lu refine 2", 128, torch.float32, {"L4": 1, "L5": 3}),
    ("solve lu refine 2", 384, torch.float32, {"L5": 2}),   # K3, K5 getrf
    ("slogdet", 128, torch.float32, {"L4": 1}),
    ("lu_solve_matrix", 128, torch.float32, {"L4": 1, "L5": 1}),
    ("lu_inverse_refined", 128, torch.float64, {"L4": 1, "L5": 1}),
    ("inverse lu", 384, torch.float64, {"L3": 3}),
    ("solve auto", 512, torch.float64, {"L3": 4}),
    ("slogdet", 384, torch.float64, {"L3": 3}),
])
def test_lu_paths_call_the_loops(path, n, dtype, want, wrapper_calls):
    """Each user path of the LU module calls L3, L4 and L5 as often as the
    JAX package runs their loops (the blocked getrf's panels at b = 128),
    and its result is right."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    x = torch.from_numpy(a).to(dtype)
    rhs = torch.from_numpy(rng.standard_normal((n, 2))).to(dtype)
    if path == "inverse lu":
        out, ok = tmi.inverse(x, method="lu")
        resid = np.abs(a @ out.double().numpy() - np.eye(n)).max()
    elif path == "lu_inverse_refined":
        out, ok = trefine.lu_inverse_refined(x, iters=2,
                                             residual_dtype=torch.float64)
        resid = np.abs(a @ out.numpy() - np.eye(n)).max()
    elif path == "slogdet":
        sign, logabs, ok = tmi.slogdet(x)
        want_sign, want_log = np.linalg.slogdet(a)
        resid = abs(float(logabs) - want_log) / abs(want_log)
        assert float(sign) == want_sign
    else:
        if path == "lu_solve_matrix":
            out, ok = tlu.lu_solve_matrix(x, rhs)
        else:
            out, ok = tmi.solve(x, rhs, method=path.split()[1],
                                refine_iters=2 if "refine" in path else 0)
        resid = np.abs(a @ out.double().numpy() - rhs.double().numpy()).max()
    assert wrapper_calls == {"L3": 0, "L4": 0, "L5": 0, **want}
    assert bool(ok) and resid < (1e-9 if dtype == torch.float64 else 1e-4)


def test_fp64_getrf_4096_runs_32_panels(monkeypatch):
    """FP64 getrf at n = 4096 (b = 128) runs the panel loop 32 times, as
    the JAX package's fori_loop does (shapes only: the port on meta
    tensors, the panel stubbed to count its calls)."""
    calls = []

    def panel(strip, used, kb, *, b, pivot):
        calls.append(kb)
        return (strip, torch.arange(kb, kb + b, dtype=torch.int32,
                                    device=strip.device), used,
                torch.ones((), dtype=torch.bool, device=strip.device))

    monkeypatch.setattr(tlu, "_lu_panel", panel)
    a = torch.empty((4096, 4096), dtype=torch.float64, device="meta")
    fac, perm, ok = tlu.lu_factor_blocked(a)
    assert calls == list(range(0, 4096, 128))
    assert fac.shape == (4096, 4096) and perm.shape == (4096,)
