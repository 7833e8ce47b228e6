"""On-card checks of the port's CUDA kernels against their plain twins.

Marked ``gpu``: they need an NVIDIA Hopper GPU and ``nvcc``, and skip
without a CUDA device (decided inside the ``cuda`` fixture, so every
pytest worker collects the same tests). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have.)

The compiled routes (``utils/graphs.py``): each replayed bit for bit as it
runs eagerly, with the eager launch counts; a held result survives later
replays; a capture that syncs the host raises. The profiler spans
(``utils/profiling.span``): a replay's span holds its graph launch, and no
device record launched inside a span starts before its launch (the clock
check).

L1 and L2 (the FP64 routes' loops): L1 bit for bit against its twin up to
the sign of a zero, ok equal; L2's pivot rows and ok identical; each FP64
route launches them and never runs the plain loops.

L3, L4 and L5 (the LU module's loops): bit for bit against their twins,
NaN and infinite inputs included (NaN where the twin has NaN), ok equal;
each LU route launches them and never runs the plain loops.

The flat API's readback: the answer lands in page-locked memory, bit for
bit what ``inv.cpu()`` reads; held answers share no memory; a view keeps
its block alive; dropped answers' blocks serve later calls with no new
page-locked allocation; a failed page-locked allocation reads back
pageable.

Tolerances: pivot sequences identical, ok equal, values within 1e-4 of
max|twin|; K1, K4 and K5 also elementwise against the twin
(``_hold_to_twin``), K1's cluster branch byte-identical across cluster
sizes; K2 bit for bit against its twin on the CPU, K6 against K2 per
matrix and that twin; K7 as its test states.

Each kernel is held at its callers' shapes, and each path of the public
API at the shapes the main path and the benchmark use: its kernels'
launch counts, its residual gate, the plain loops never run
(``test_path_launches_its_kernels_and_meets_its_gate``); each kernel and
route bit for bit over poisoned runs (``test_poisoned_runs_are_identical``);
each compiled route replayed as it runs eagerly, and A, B, A leaving A's
held result unchanged (``test_replay_equals_eager``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gpu_matrix_inversion_tpu_torch as tpkg  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import (  # noqa: E402
    blocked, fused, gauss_jordan, lockstep, lu, matmul)
from gpu_matrix_inversion_tpu_torch.ops.refine import (  # noqa: E402
    lu_inverse_refined)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    # No graph from an earlier test: a compiled route's first call here
    # runs its eager warm-up, whose launches the kernel wrappers count.
    graphs.clear()
    return torch.device("cuda", 0)


def _rel(x, ref) -> float:
    return float((x.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def _hold_to_twin(got, want) -> int:
    """Elementwise, as test_k5_matches_twin: the kernels and the twins take
    the same operations in the same order, and part only where the twin's
    float64 emulation of fmaf rounds twice (a halfway case) or where a zero
    carries the other sign (K1 and K4 skip the dead entries of [X | I], so
    a zero there starts from +0, not from -0). So every element within
    1e-6 (|twin| + 1), and at most 1 in 1000 elements differing in their
    bits other than by the sign of a zero; one skipped update or a
    multiplier off by a percent breaks the first, a division that rounds
    otherwise the second. Returns the count of differing elements."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((got.double() - want.double()).abs()
                 <= 1e-6 * (want.double().abs() + 1)).all())
    ints = torch.int32 if got.element_size() == 4 else torch.int16
    differ = int(((got.view(ints) != want.view(ints))
                  & ~((got == 0) & (want == 0))).sum())
    assert differ * 1000 <= got.numel()
    return differ


def _block_values(rng, shape, kind: str) -> np.ndarray:
    """Inputs for the pivot rules: standard normal, integers in [-3, 3]
    (exact ties in |column|), or quarter steps plus 1e-3 noise (near
    ties)."""
    if kind == "integers":
        return rng.integers(-3, 4, shape).astype(np.float32)
    if kind == "quarters":
        return (rng.integers(-8, 9, shape) / 4
                + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
    if kind == "padded":     # a 300^2 matrix in the identity, as K1 gets it
        a = np.broadcast_to(np.eye(shape[-1], dtype=np.float32),
                            shape).copy()
        a[..., :300, :300] = rng.standard_normal((*shape[:-2], 300, 300))
        return a
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bsz,m,pivot,dtype,kind", [
    (4096, 128, True, torch.float32, "normal"),  # the main path's batch
    (1, 256, True, torch.float32, "normal"),     # matrix_inv_32 at n = 256
    (8, 128, True, torch.float32, "normal"),     # register branch
    (8, 128, False, torch.float32, "normal"),
    (8, 128, True, torch.bfloat16, "normal"),
    (8, 128, True, torch.float32, "integers"),
    (8, 128, True, torch.float32, "quarters"),
    (8, 128, False, torch.float32, "quarters"),
    (8, 128, True, torch.bfloat16, "quarters"),
    (2, 256, True, torch.float32, "normal"),     # cluster branch
    (1, 640, True, torch.float32, "normal"),
    (2, 256, True, torch.float32, "integers"),
    (1, 640, True, torch.float32, "integers"),
    (2, 384, False, torch.float32, "normal"),
    (2, 512, True, torch.bfloat16, "quarters"),
    (4, 640, True, torch.float32, "normal"),
    (1, 384, True, torch.float32, "padded"),
    (2, 512, False, torch.bfloat16, "normal"),
])
def test_k1_matches_twin(cuda, bsz, m, pivot, dtype, kind):
    """K1 against its twin on the card (pos identical, ok equal, 1e-4) and
    elementwise against the twin on the CPU, on random and tie-heavy
    inputs (the packed key's tie-break by row). On the main path's 4096
    matrices the twin takes minutes on the CPU: there the elementwise
    reference is the twin on the card, as in test_k1_ragged_waves."""
    rng = np.random.default_rng(m + bsz)
    a = _block_values(rng, (bsz, m, m), kind)
    if not pivot:
        a += m * np.eye(m, dtype=np.float32)
    x = torch.from_numpy(a).to(cuda).to(dtype)
    before = fused.gj_kernel.launches
    inv_k, pos_k, ok_k = fused.gj_kernel(x, pivot=pivot)
    assert fused.gj_kernel.launches == before + 1
    inv_t, pos_t, ok_t = fused.gj_twin(x, pivot=pivot)
    assert torch.equal(pos_k, pos_t)
    assert torch.equal(ok_k, ok_t) and bool(ok_k.all())
    assert _rel(inv_k, inv_t) <= 1e-4
    if bsz > 64:
        _hold_to_twin(inv_k, inv_t)
        return
    inv_c, pos_c, ok_c = fused.gj_twin(x.cpu(), pivot=pivot)
    assert torch.equal(pos_k.cpu(), pos_c) and torch.equal(ok_k.cpu(), ok_c)
    _hold_to_twin(inv_k, inv_c)


@pytest.mark.parametrize("m,bsz", [(256, 1), (256, 4), (384, 1)])
def test_k1_cluster_size_changes_no_bit(cuda, monkeypatch, m, bsz):
    """K1's cluster branch at the smallest C that fits (2 at m = 256, 4 at
    384) and at the 8 the geometry grows to for a batch that leaves SMs
    idle: inverse, pos and ok byte-identical."""
    rng = np.random.default_rng(m + bsz)
    x = torch.from_numpy(_block_values(rng, (bsz, m, m), "quarters")).to(cuda)
    c_min = 2 if m == 256 else 4
    out = {}
    for cmax in (c_min, 8):
        monkeypatch.setattr(fused, "MAX_CLUSTER", cmax)
        geo, _ = fused.cluster_plan(m, bsz)
        assert geo.cluster == cmax
        out[cmax] = fused.gj_kernel(x, pivot=True)
    (i1, p1, o1), (i2, p2, o2) = out.values()
    assert torch.equal(i1.view(torch.int32), i2.view(torch.int32))
    assert torch.equal(p1, p2) and torch.equal(o1, o2) and bool(o1.all())


@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_k1_ragged_waves(cuda, per_sm):
    """Batches of 1, 2 and 3 matrices per SM plus seven (a ragged last
    wave: two blocks share an SM), against the twin on the card
    elementwise; and the occupancy the register branch was built for."""
    assert fused.blocks_per_sm() >= 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bsz = per_sm * sms + 7
    rng = np.random.default_rng(per_sm)
    x = torch.from_numpy(_block_values(rng, (bsz, 128, 128),
                                       "quarters")).to(cuda)
    inv_k, pos_k, ok_k = fused.gj_kernel(x, pivot=True)
    inv_t, pos_t, ok_t = fused.gj_twin(x, pivot=True)
    assert torch.equal(pos_k, pos_t)
    assert torch.equal(ok_k, ok_t) and bool(ok_k.all())
    _hold_to_twin(inv_k, inv_t)


@pytest.mark.parametrize("m,b,kb", [(256, 64, 0), (1024, 128, 128),
                                    (4096, 128, 0), (4096, 128, 128),
                                    (16384, 64, 0)])
def test_k2_matches_twin(cuda, m, b, kb):
    rng = np.random.default_rng(m + b)
    strip = torch.from_numpy(
        rng.standard_normal((b, m)).astype(np.float32)).to(cuda)
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    used[:kb] = 1
    p_k, ct_k, ok_k = blocked.panel_factor(strip, kb, used, pivot=True)
    p_t, ct_t, ok_t = blocked.panel_factor_twin(strip, kb, used, pivot=True)
    assert torch.equal(p_k, p_t)
    assert bool(ok_k) and bool(ok_t)
    assert not bool(used[p_k.long()].any())
    assert _rel(ct_k, ct_t) <= 1e-4


@pytest.mark.parametrize("m,b,dtype", [
    (4096, 128, torch.float32), (4096, 128, torch.bfloat16),
    (20032, 64, torch.bfloat16), (4096, 256, torch.float32),
    (65536, 32, torch.bfloat16)])
def test_k3_matches_twin(cuda, m, b, dtype):
    """K3 at the split path's, LU's and the FP64 tier's shapes, and at the
    largest m the gates admit, with a third of the rows already used."""
    rng = np.random.default_rng(m + b)
    strip = torch.from_numpy(
        rng.standard_normal((b, m)).astype(np.float32)).to(cuda).to(dtype)
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    used[::3] = 1
    before = blocked.pivot_search.launches
    p_k = blocked.pivot_search(strip, used)
    assert blocked.pivot_search.launches == before + 1
    p_t = blocked.pivot_search_twin(strip, used)
    assert torch.equal(p_k, p_t)
    assert not bool(used[p_k.long()].any())


def _twin_on_cpu(strip, kb, used, pivot):
    """K2's twin run on the CPU, the bit reference of K2, K3 and K6 (its
    deferred dot sums in the kernels' order there; on the card the twin's
    is a cuBLAS product, which does not)."""
    p, ct, ok = blocked.panel_factor_twin(strip.cpu(), kb, used.cpu(),
                                          pivot=pivot)
    return p, ct, bool(ok)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _strip_and_mask(cuda, m, b, mask, seed, dtype=torch.float32):
    """A standard normal (b, m) strip and an empty mask, or the mask of a
    prior panel (the twin's pivot rows of another strip)."""
    rng = np.random.default_rng(seed)
    strip = torch.from_numpy(
        rng.standard_normal((b, m)).astype(np.float32)).to(cuda)
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    if mask == "prior":
        other = torch.from_numpy(
            rng.standard_normal((b, m)).astype(np.float32)).to(dtype)
        used[blocked.pivot_search_twin(other, used.cpu()).long()] = 1
    return strip.to(dtype), used


K2_GATE_SHAPES = [(256, 64), (1024, 128), (2048, 128), (4096, 128),
                  (8192, 128), (16384, 64)]


@pytest.mark.parametrize("mask", ["empty", "prior"])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("m,b", K2_GATE_SHAPES)
def test_k2_cluster_bits(cuda, monkeypatch, m, b, pivot, mask):
    """K2, one cluster per panel, at every shape the gates give it: pivot
    rows, C^T and ok byte-identical to the twin run on the CPU; at C = 8
    byte-identical to C = 16. Without pivoting the strip is made dominant
    at rows kb..kb+b."""
    strip, used = _strip_and_mask(cuda, m, b, mask, m + b)
    kb = b if mask == "prior" else 0
    if not pivot:
        strip[:, kb:kb + b] += b * torch.eye(b, device=cuda)
    before = blocked.panel_factor.launches
    p2, ct2, ok2 = blocked.panel_factor(strip, kb, used, pivot=pivot)
    assert blocked.panel_factor.launches == before + 1
    p_t, ct_t, ok_t = _twin_on_cpu(strip, kb, used, pivot)
    assert torch.equal(p2.cpu(), p_t)
    assert torch.equal(_bits(ct2.cpu()), _bits(ct_t))
    assert bool(ok2) and ok_t
    if pivot:
        assert not bool(used[p2.long()].any())
    monkeypatch.setattr(blocked, "MAX_CLUSTER", 8)
    geo, _ = blocked.cluster_plan(0, m, b, blocked._factor_geometry(m, b)[0])
    assert geo.cluster <= 8
    p8, ct8, ok8 = blocked.panel_factor(strip, kb, used, pivot=pivot)
    assert torch.equal(p8, p2) and torch.equal(_bits(ct8), _bits(ct2))
    assert bool(ok8) == bool(ok2)


@pytest.mark.parametrize("mask", ["empty", "prior"])
@pytest.mark.parametrize("m,b,dtype", [
    (4096, 128, torch.float32), (4096, 128, torch.bfloat16),
    (4096, 256, torch.float32), (20032, 64, torch.bfloat16),
    (65536, 32, torch.bfloat16)])
def test_k3_cluster_bits(cuda, monkeypatch, m, b, dtype, mask):
    """K3 at every shape the gates give it: pivot rows equal to the twin's
    on the CPU, equal at C = 8 and C = 16, and for an fp32 strip equal to
    K2's (K3 runs K2's steps)."""
    strip, used = _strip_and_mask(cuda, m, b, mask, m + b + 1, dtype)
    p3 = blocked.pivot_search(strip, used)
    assert torch.equal(p3.cpu(), blocked.pivot_search_twin(strip.cpu(),
                                                           used.cpu()))
    if dtype == torch.float32:
        assert torch.equal(p3, blocked.panel_factor(strip, 0, used,
                                                    pivot=True)[0])
    monkeypatch.setattr(blocked, "MAX_CLUSTER", 8)
    assert torch.equal(blocked.pivot_search(strip, used), p3)


@pytest.mark.parametrize("case", ["singular", "nan"])
def test_k2_cluster_flags_singular_and_nan(cuda, case):
    """A strip with an all-zero column (a zero pivot at step 5) and one with
    a NaN: ok false, as the twin on the CPU says, and the same pivot rows
    and values (NaNs where it has NaNs) as that twin."""
    strip, used = _strip_and_mask(cuda, 4096, 128, "empty", 7)
    if case == "singular":
        strip[5] = 0.0
    else:
        strip[9, 300] = float("nan")
    p2, ct2, ok2 = blocked.panel_factor(strip, 0, used, pivot=True)
    p_t, ct_t, ok_t = _twin_on_cpu(strip, 0, used, True)
    assert not bool(ok2) and not ok_t
    assert torch.equal(p2.cpu(), p_t)
    torch.testing.assert_close(ct2.cpu(), ct_t, rtol=0, atol=0,
                               equal_nan=True)


def test_cluster_launch_is_checked(cuda):
    """The cluster geometry the card admits: C = 16 or the portable 8 at
    (4096, 128), with at least one cluster resident; a geometry the kernel
    refuses raises and launches nothing."""
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    geo, clusters = blocked.cluster_plan(0, 4096, 128, 16)
    assert geo.cluster in (8, 16) and clusters >= 1
    lib = cuda_build.load()
    strip = torch.zeros((128, 4096), device=cuda)
    out = torch.empty((128, 4096), device=cuda)
    used = torch.zeros(4096, dtype=torch.int32, device=cuda)
    pivrows = torch.empty(128, dtype=torch.int32, device=cuda)
    ok = torch.empty(1, dtype=torch.int32, device=cuda)
    err = lib.matinv_panel_factor(
        strip.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
        out.data_ptr(), ok.data_ptr(), None, 4096, 128, 16, 4095, 0, 1,
        geo.cluster, geo.threads, 1, 1, 1024,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0                        # smem below the placement's
    with pytest.raises(RuntimeError, match="K2"):
        cuda_build.check(err, "K2 panel_factor")


@pytest.mark.parametrize("kernel,shape", [
    ("K2", (4096, 128)), ("K2", (16384, 64)), ("K3 fp32", (4096, 128)),
    ("K3 bf16", (20032, 64)), ("K3 bf16", (65536, 32)),
    ("K6", (1024, 128)), ("K6", (2048, 128)),
    ("K1", (256, 1)), ("K1", (256, 512)), ("K1", (384, 1)),
    ("K1", (384, 64)), ("K1", (512, 1)), ("K1", (640, 64)),
    ("L1 fp64", (256, 1)), ("L1 fp64", (256, 64)), ("L1 fp64", (511, 1)),
    ("L4 fp32", (128, 64)), ("L4 fp64", (200, 1))])
def test_the_card_admits_each_cluster(cuda, kernel, shape):
    """The cluster kernels at their callers' shapes ((m, b) of a panel;
    (m, batch) of K1; (n, batch) of L1 and L4): the card holds at least
    one cluster of the geometry each launches with (the plans raise where
    it holds none). K6 runs K2's geometry, one cluster a matrix."""
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    if kernel[0] == "K" and kernel != "K1":
        m, b = shape
        kind = {"K2": 0, "K6": 0, "K3 fp32": 1, "K3 bf16": 2}[kernel]
        geo, resident = blocked.cluster_plan(
            kind, m, b, blocked._factor_geometry(m, b)[0])
        assert geo.cluster in (2, 4, 8, 16)
    elif kernel == "K1":
        geo, resident = fused.cluster_plan(*shape)
    else:
        n, bsz = shape
        dtype = torch.float64 if kernel.endswith("fp64") else torch.float32
        geo, resident = gauss_jordan.loop_plan(n, bsz, dtype, cuda,
                                               lu=kernel.startswith("L4"))
        assert geo.branch == "cluster"
    assert resident >= 1


@pytest.mark.parametrize("b,pivot", [(64, True), (128, True), (32, False)])
def test_k4_matches_twin(cuda, b, pivot):
    # 256 random blocks, so that row swaps happen at nearly every step of
    # many blocks in flight at once (a race between warps shows here), and
    # one singular block.
    rng = np.random.default_rng(b)
    d = rng.standard_normal((257, b, b)).astype(np.float32)
    if not pivot:
        d += b * np.eye(b, dtype=np.float32)
    d[-1, :, 7] = 0.0
    x = torch.from_numpy(d).to(cuda)
    inv_k, ok_k = blocked.invert_small(x, pivot=pivot)
    inv_t, ok_t = blocked.invert_small_twin(x, pivot=pivot)
    assert ok_k.tolist() == ok_t.tolist() == [True] * 256 + [False]
    assert _rel(inv_k[:-1], inv_t[:-1]) <= 1e-4
    _hold_to_twin(inv_k[:-1], inv_t[:-1])


@pytest.mark.parametrize("kind", ["integers", "quarters"])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("b", [128, 64, 40])
def test_k4_ties_match_twin_on_cpu(cuda, b, pivot, kind):
    """K4 on tie-heavy blocks (exact and near ties in |column|: the swap
    order decides them), a singular block and a NaN block, elementwise
    against the twin on the CPU; ok equal. b = 40 leaves rows and column
    slots of the register layout empty."""
    rng = np.random.default_rng(b + 2 * pivot)
    d = _block_values(rng, (4, b, b), kind)
    if not pivot:
        d += b * np.eye(b, dtype=np.float32)
    d[2, :, 7] = 0.0
    d[3, 5, 9] = np.nan
    x = torch.from_numpy(d).to(cuda)
    inv_k, ok_k = blocked.invert_small(x, pivot=pivot)
    inv_c, ok_c = blocked.invert_small_twin(x.cpu(), pivot=pivot)
    assert ok_k.tolist() == ok_c.tolist() == [True, True, False, False]
    _hold_to_twin(inv_k[:2], inv_c[:2])


@pytest.mark.parametrize("bsz", [3, 257])
@pytest.mark.parametrize("b", [128, 64, 40, 8])
def test_k5_matches_twin(cuda, b, bsz):
    """K5 at getrf's b = 128 and at smaller blocks that leave warps, rows
    and columns of its register layout empty; on 257 blocks, many are in
    flight at once. The last block has a zero pivot."""
    rng = np.random.default_rng(5 + b)
    d = rng.standard_normal((bsz, b, b)).astype(np.float32)
    d += b * np.eye(b, dtype=np.float32)
    d[-1, 7, :8] = 0.0                     # a zero pivot
    x = torch.from_numpy(d).to(cuda)
    lu_k, ok_k = lu.small_lu(x)
    lu_t, ok_t = lu.small_lu_twin(x)
    assert ok_k.tolist() == ok_t.tolist() == [True] * (bsz - 1) + [False]
    assert _rel(lu_k[:-1], lu_t[:-1]) <= 1e-4
    # Elementwise: the twin on the CPU takes the same operations in the
    # same order, and parts from K5 only where its float64 emulation of
    # fmaf rounds twice; one skipped update or a multiplier off by a
    # percent breaks this bound, and a division or an update that rounds
    # otherwise parts in the bits of far more than one element in a
    # thousand.
    got, want = lu_k[:-1].cpu(), lu.small_lu_twin(x[:-1].cpu())[0]
    assert bool(((got.double() - want.double()).abs()
                 <= 1e-6 * (want.double().abs() + 1)).all())
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert differ * 1000 <= got.numel()


def test_k5_rejects_blocks_past_128(cuda):
    before = lu.small_lu.launches
    with pytest.raises(ValueError, match="1 to 128"):
        lu.small_lu(torch.eye(129, device=cuda))
    assert lu.small_lu.launches == before


def test_new_paths_launch_their_kernels(cuda):
    """The split path launches K3 and K4, the FP64 tier K3, the LU route
    K3 and K5; each meets its residual gate."""
    from gpu_matrix_inversion_tpu_torch import inverse, solve
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    a32 = hollow_random_matrix(1024, seed=4)
    a64 = hollow_random_matrix(1024, seed=4, dtype=np.float64)
    k3, k4, k5 = (blocked.pivot_search.launches,
                  blocked.invert_small.launches, lu.small_lu.launches)
    inv, ok = inverse(torch.from_numpy(a32).to(cuda), search_bf16=True)
    assert bool(ok) and relative_residual(a32, inv.cpu().numpy()) < 1e-6
    assert blocked.invert_small.launches > k4
    inv, ok = inverse(torch.from_numpy(a64).to(cuda))
    assert bool(ok) and relative_residual(a64, inv.cpu().numpy()) < 1e-13
    k3_mid = blocked.pivot_search.launches
    assert k3_mid > k3
    inv, ok = inverse(torch.from_numpy(a32).to(cuda), method="lu")
    assert bool(ok) and relative_residual(a32, inv.cpu().numpy()) < 1e-5
    assert lu.small_lu.launches > k5 and blocked.pivot_search.launches > k3_mid
    b = torch.ones(1024, 2, device=cuda)
    x, ok = solve(torch.from_numpy(a32).to(cuda), b)
    assert bool(ok) and x.shape == (1024, 2)


@pytest.mark.parametrize("case", ["empty", "prior", "no_pivot"])
@pytest.mark.parametrize("k,m", [(8, 1024), (4, 2048)])
def test_k6_equals_k2_per_matrix(cuda, k, m, case):
    """K6 at the lockstep gate's full shapes (b = 128): per matrix, bit
    for bit what K2 gives on that matrix alone, and what the twin gives on
    the CPU; against the twin on the card, K2's tolerance (pivot rows
    identical, C^T within 1e-4: there the twin's deferred dot is a cuBLAS
    product, which sums in another order at m = 1024)."""
    from gpu_matrix_inversion_tpu_torch.ops import lockstep
    b = 128
    rng = np.random.default_rng(k * m)
    strips = torch.from_numpy(
        rng.standard_normal((k, b, m)).astype(np.float32)).to(cuda)
    used = torch.zeros((k, m), dtype=torch.int32, device=cuda)
    kb, pivot = 0, case != "no_pivot"
    if case == "prior":
        for i in range(k):
            used[i, blocked.panel_factor(strips[i], 0, used[i],
                                         pivot=True)[0].long()] = 1
        kb = b
    elif case == "no_pivot":
        strips[:, :, :b] += b * torch.eye(b, device=cuda)
    before = lockstep.lockstep_factor.launches
    p6, ct6, ok6 = lockstep.lockstep_factor(strips, kb, used, pivot=pivot)
    assert lockstep.lockstep_factor.launches == before + 1
    p_t, ct_t, ok_t = lockstep.lockstep_factor_twin(strips, kb, used,
                                                    pivot=pivot)
    for i in range(k):
        p2, ct2, ok2 = blocked.panel_factor(strips[i], kb, used[i],
                                            pivot=pivot)
        assert torch.equal(p6[i], p2) and torch.equal(ct6[i], ct2)
        assert bool(ok6[i]) == bool(ok2)
    p_c, ct_c, ok_c = lockstep.lockstep_factor_twin(
        strips.cpu(), kb, used.cpu(), pivot=pivot)
    assert torch.equal(p6.cpu(), p_c) and torch.equal(ct6.cpu(), ct_c)
    assert ok6.tolist() == ok_c.tolist()
    assert torch.equal(p6, p_t) and _rel(ct6, ct_t) <= 1e-4
    assert ok6.tolist() == ok_t.tolist() == [True] * k


# (m, k, n, base offset of A in elements, stride-pad copies K7 makes in
# fp32 and in bf16).
K7_CASES = {
    "4096x4096x4096": (4096, 4096, 4096, 0, (0, 0)),  # the main path's
    "300x200x150": (300, 200, 150, 0, (1, 1)),       # edge tiles
    "1024x512x768": (1024, 512, 768, 0, (0, 0)),
    "ragged 1000x1001x999": (1000, 1001, 999, 0, (2, 2)),
    "misaligned 256x136x200": (256, 136, 200, 1, (1, 1)),
    "k=0 64x0x48": (64, 0, 48, 0, (0, 0)),
}


@pytest.mark.parametrize("case", list(K7_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_matches_twin(cuda, case, dtype):
    """K7's output in the operands' dtype at edge tiles, at k and n that
    are not multiples of 8 (both operands take the stride-pad copy), on an
    A whose base is off 16 bytes, and at k = 0 (zeros). fp32: within
    matmul.fp32_error_bound of the float64 product, which a TF32 product
    and one of bf16-rounded operands both exceed on most elements. bf16:
    within matmul.error_bound of its twin."""
    from gpu_matrix_inversion_tpu_torch.ops import matmul
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    m, k, n, offset, pads = K7_CASES[case]
    rng = np.random.default_rng(m + k)
    flat = torch.from_numpy(rng.standard_normal(offset + m * k).astype(
        np.float32)).to(cuda).to(dtype)
    a = flat[offset:].view(m, k)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(cuda).to(dtype)
    before = matmul.tiled_matmul.launches
    padded = matmul.tiled_matmul.padded
    out = matmul.tiled_matmul(a, b)
    assert matmul.tiled_matmul.launches == before + 1
    assert matmul.tiled_matmul.padded == padded + pads[dtype != torch.float32]
    assert out.dtype == dtype and out.shape == (m, n)
    if dtype == torch.bfloat16:
        twin = matmul.tiled_matmul_twin(a, b)
        diff = (out.float() - twin.float()).abs()
        assert bool((diff <= matmul.error_bound(a, b)).all())
        return
    if k == 0:
        assert not bool(out.any())
        return
    exact = a.double() @ b.double()
    tol = matmul.fp32_error_bound(a, b)
    assert bool(((out.double() - exact).abs() <= tol).all())
    with matmul_precision("high"):
        tf32 = a @ b
    rounded = matmul.tiled_matmul(a.bfloat16().float(), b.bfloat16().float())
    for control in (tf32, rounded):
        over = (control.double() - exact).abs() > tol
        assert float(over.double().mean()) > 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_reads_nothing_past_k(cuda, dtype):
    """A one-row A that views the first 1001 columns of a (1, 1008) row
    whose last seven hold inf: it counts as contiguous and its stride and
    base are aligned, but read in place, the last 16-byte unit of its row
    would bring inf into the fp32 product (0 * inf = NaN). It takes the
    stride-pad copy; B (1001 x 72, aligned) takes none."""
    from gpu_matrix_inversion_tpu_torch.ops import matmul
    rng = np.random.default_rng(1001)
    wide = torch.full((1, 1008), float("inf"), dtype=dtype, device=cuda)
    wide[:, :1001] = torch.from_numpy(
        rng.standard_normal((1, 1001)).astype(np.float32)).to(cuda)
    a = wide[:, :1001]
    b = torch.from_numpy(rng.standard_normal((1001, 72)).astype(
        np.float32)).to(cuda).to(dtype)
    padded = matmul.tiled_matmul.padded
    out = matmul.tiled_matmul(a, b)
    assert matmul.tiled_matmul.padded == padded + 1
    twin = matmul.tiled_matmul_twin(a, b)
    assert bool(torch.isfinite(out).all())
    diff = (out.float() - twin.float()).abs()
    assert bool((diff <= matmul.error_bound(a, b)).all())


def test_lockstep_route_launches_k6(cuda, monkeypatch):
    """MATINV_LOCKSTEP=1 on a (5, 1024, 1024) batch: K6 only (k = 5, eight
    panels), equal bit for bit to the per-matrix route, refined residuals
    <= 1e-6, and a singular member flagged alone."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.ops import lockstep
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_kernels, kernel_launches)
    batch = np.stack([hollow_random_matrix(1024, seed=30 + i)
                      for i in range(5)])
    batch[3] = 1.0
    x = torch.from_numpy(batch).to(cuda)
    off, ok_off = inverse(x)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    k2, k6 = blocked.panel_factor.launches, lockstep.lockstep_factor.launches
    on, ok_on = inverse(x)
    # The call is compiled (utils/graphs.py): its first call with this
    # signature launches K6 8 times in its eager warm-up, then replays the
    # graph, which runs no wrapper. The profiler counts a replay's kernels.
    assert blocked.panel_factor.launches == k2
    assert lockstep.lockstep_factor.launches == k6 + 8
    again = []
    rows = device_kernels(lambda: again.append(inverse(x)[0]))
    assert _nodes(1) == {"K2/K6": 8}
    assert _at_most(kernel_launches(rows), {"K2/K6": 8})
    assert blocked.panel_factor.launches == k2
    assert lockstep.lockstep_factor.launches == k6 + 8
    torch.testing.assert_close(again[0], on, rtol=0, atol=0, equal_nan=True)
    # Bit for bit; the singular member's output may hold NaNs, which
    # torch.equal never calls equal.
    torch.testing.assert_close(on, off, rtol=0, atol=0, equal_nan=True)
    assert ok_on.tolist() == ok_off.tolist() == [True] * 3 + [False, True]
    keep = [0, 1, 2, 4]
    a64, x64 = x[keep].double(), on[keep].double()
    eye = torch.eye(1024, dtype=torch.float64, device=cuda)
    res = (torch.linalg.matrix_norm(a64 @ x64 - eye)
           / (torch.linalg.matrix_norm(a64) * torch.linalg.matrix_norm(x64)))
    assert float(res.max()) <= 1e-6


@pytest.mark.parametrize("n", [512, 4096])
def test_ns_and_inverter(cuda, n):
    """inverse(method="ns") (also mixed=True) and Inverter on the card: the
    JAX package's gates (Newton-Schulz residual <= 1e-5, ok false on a
    singular input; the blocked route polished once <= 1e-6)."""
    from gpu_matrix_inversion_tpu_torch import Inverter, inverse
    from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (
        newton_schulz_inverse)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
    w = well_conditioned_matrix(n, seed=92)
    xw = torch.from_numpy(w).to(cuda)
    x, ok = inverse(xw, method="ns")
    assert bool(ok) and _card_residual(w, x) < 1e-5
    x, ok = newton_schulz_inverse(xw, mixed=True)
    assert bool(ok) and _card_residual(w, x) < 1e-5
    _, ok = inverse(torch.ones(n // 2, n // 2, device=cuda), method="ns")
    assert not bool(ok)
    h = hollow_random_matrix(max(n, 1024), seed=93)
    for method, src, gate in (("blocked", h, 1e-6), ("ns", w, 1e-5)):
        x, ok = Inverter(method=method, refine_iters=1).inverse(src)
        assert x.device.type == "cuda"
        assert bool(ok) and _card_residual(src, x) < gate


@pytest.mark.parametrize("bsz,n,k6", [(16, 1024, 16), (8, 2048, 32),
                                      (5, 2048, 32)])
def test_lockstep_route_at_the_gate_shapes(cuda, monkeypatch, bsz, n, k6):
    """The lockstep route at the JAX package's recorded lockstep shapes
    (k = 8 at n = 1024: 2 chunks of 8 panels; k = 4 at n = 2048: 2 of 16)
    and with an odd tail (5 at n = 2048: chunks of 4 and 1): the first
    call's warm-up launches K6 ``k6`` times and K2 never, the replayed
    graph holds the panel kernel as often (the profiler's records of a
    replay: test_lockstep_replay_equals_eager); raw and refined bit for
    bit the per-matrix route's; refined <= 1e-6, raw <= 1e-4."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    x = torch.stack([_hollow(cuda, n, n + i) for i in range(bsz)])
    off, ok_off = inverse(x)
    off_raw, _ = blocked.blocked_inverse(x, refine=0)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    graphs.clear()
    before = _counts()
    on, ok_on = inverse(x)
    assert _grown(before) == {"K6": k6}
    replayed = inverse(x)[0]
    assert _nodes(1) == {"K2/K6": k6}
    on_raw, ok_raw = blocked.blocked_inverse(x, refine=0)
    _assert_bits(replayed, on)
    _assert_bits(on, off)
    _assert_bits(on_raw, off_raw)
    assert bool(ok_on.all()) and bool(ok_off.all()) and bool(ok_raw.all())
    assert _card_residual(x, on) <= 1e-6 and _card_residual(x, on_raw) <= 1e-4


def test_k1_flags_singular_and_nan(cuda):
    a = torch.eye(128).repeat(3, 1, 1)
    a[1] = 1.0
    a[2, 3, 4] = float("nan")
    _, _, ok = fused.gj_kernel(a.to(cuda).contiguous(), pivot=True)
    assert ok.tolist() == [True, False, False]


def test_main_path_launches_kernels_and_repeats(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    k1, k2 = fused.gj_kernel.launches, blocked.panel_factor.launches
    small = torch.from_numpy(hollow_random_matrix(200, seed=1)).to(cuda)
    inv, ok = inverse(small)
    assert bool(ok) and fused.gj_kernel.launches > k1
    big_np = hollow_random_matrix(1024, seed=2)
    big = torch.from_numpy(big_np).to(cuda)
    first, ok = inverse(big)
    assert bool(ok) and blocked.panel_factor.launches > k2
    second, _ = inverse(big)
    assert torch.equal(first, second)
    assert relative_residual(big_np, first.cpu().numpy()) < 1e-6


# --------------------------------------------------------------------------
# The public API's paths at the main path's and the benchmark's shapes
# --------------------------------------------------------------------------


def _card_residual(a, x) -> float:
    """utils/residual.py's relative residual ||A X - I||_F / (||A||_F
    ||X||_F) in float64 on the card, the largest over a batch; ``a`` and
    ``x`` numpy arrays or tensors, ``x`` possibly flat."""
    a = torch.as_tensor(a).to("cuda").double()
    x = torch.as_tensor(x).to("cuda").double().reshape(a.shape)
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    r = torch.linalg.matrix_norm(a @ x - eye) / (
        torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(x))
    return float(r.max())


def _backward_error(a, x, b) -> float:
    """||A x - b|| / (||A|| ||x||) in float64."""
    a, x, b = a.double(), x.double(), b.double()
    return float(torch.linalg.norm(a @ x - b)
                 / (torch.linalg.norm(a) * torch.linalg.norm(x)))


def _hollow(cuda, n, seed, dtype=np.float32):
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    return torch.from_numpy(hollow_random_matrix(n, seed=seed,
                                                 dtype=dtype)).to(cuda)


def _dominant(cuda, n, seed):
    """An FP64 hollow matrix made diagonally dominant (no pivoting needed)."""
    h = _hollow(cuda, n, seed, np.float64)
    return h + 2 * h.abs().sum(dim=1).max() * torch.eye(
        n, dtype=torch.float64, device=cuda)


def _rhs(cuda, n, k, seed=16, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, k))).to(dtype).to(cuda)


PATHS = {}


def _path(name, **want):
    """Register ``make(cuda) -> (call, check)`` as the path ``name``, with
    the launches ``call()`` must make of each kernel named in ``want``;
    ``check`` holds its output to the path's gate."""
    def register(make):
        PATHS[name] = (make, want)
        return make
    return register


def _flat(n, seed, gate, fn="matrix_inv_32", dtype=np.float32, pivot=True):
    """A flat API call on a hollow n^2 matrix (diagonally dominant without
    pivoting), its residual within ``gate``."""
    def make(cuda):
        from gpu_matrix_inversion_tpu_torch import api
        a = (_hollow(cuda, n, seed, dtype) if pivot
             else _dominant(cuda, n, seed))
        flat = a.cpu().numpy().reshape(-1)
        del a

        def check(out):
            assert out.size == n * n
            assert _card_residual(flat.reshape(n, n), out) <= gate
        return lambda: getattr(api, fn)(flat, n, device="cuda"), check
    return make


_path("matrix_inv_32 256^2 (fused)", K1=1)(_flat(256, 256, 1e-5))
_path("matrix_inv_32 4096^2 (blocked, refined)", K2=32)(_flat(4096, 1, 1e-6))
# The input on which an XLA:TPU rewrite of the refine step once cost the
# JAX package three orders of magnitude in residual.
_path("matrix_inv_32 1950^2 seed 1950", K2=16)(
    _flat(1950, 1950, 1e-7))
_path("matrix_inv_32 20000^2 (split: K3 on bf16 strips, K4)", K3=313,
      K4=313, K2=0)(_flat(20000, 20000, 1e-6))
_path("matrix_inversion_fp64 4096^2 (K3's f32-search tier)", K3=16, L1=16,
      L2=0)(_flat(4096, 1, 1e-12, "matrix_inversion_fp64", np.float64))
_path("matrix_inversion_fp64 8192^2 (logical tier)", L1=32, L2=32, K3=0)(
    _flat(8192, 3, 1e-12, "matrix_inversion_fp64", np.float64))
_path("matrix_inversion_no_pivots 1024^2", L1=4, L2=4, K3=0)(
    _flat(1024, 5, 1e-12, "matrix_inversion_no_pivots", pivot=False))
_path("matrix_inversion_no_pivots 4096^2", L1=16, L2=16, K3=0)(
    _flat(4096, 6, 1e-12, "matrix_inversion_no_pivots", pivot=False))


@_path("inverse (4096, 128^2) (fused)", K1=1)
def _fused_batch(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    batch = np.random.default_rng(4096).uniform(
        0.0, 100.0, (4096, 128, 128)).astype(np.float32)
    batch[:, np.arange(128), np.arange(128)] = 0.0      # hollow
    x = torch.from_numpy(batch).to(cuda)

    def check(out):
        inv, ok = out
        assert bool(ok.all()) and bool(torch.isfinite(inv).all())
        assert _card_residual(x, inv) <= 1e-5
    return lambda: inverse(x), check


@_path("blocked_inverse 4096^2 raw", K2=32)
def _blocked_raw(cuda):
    x = _hollow(cuda, 4096, 1)

    def check(out):
        assert bool(out[1]) and _card_residual(x, out[0]) <= 1e-4
    return lambda: blocked.blocked_inverse(x, refine=0), check


@_path("inverse (64, 256^2) FP64 (spec)", L1=1, L2=0, K3=0)
def _spec_batch(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    x = torch.stack([_hollow(cuda, 256, s, np.float64) for s in range(64)])

    def check(out):
        assert bool(out[1].all()) and _card_residual(x, out[0]) <= 1e-12
    return lambda: inverse(x), check


@_path("blocked_inverse 4096^2 bf16 search, raw", K3=32, K4=32)
def _bf16_raw(cuda):
    x = _hollow(cuda, 4096, 1)

    def check(out):
        assert bool(out[1]) and _card_residual(x, out[0]) <= 1e-4
    return (lambda: blocked.blocked_inverse(x, search_bf16=True, refine=0),
            check)


@_path("inverse 4096^2 bf16 search, refined", K3=32, K4=32)
def _bf16_refined(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    x = _hollow(cuda, 4096, 1)

    def check(out):
        assert bool(out[1]) and _card_residual(x, out[0]) <= 1e-6
    return lambda: inverse(x, search_bf16=True), check


@_path("inverse(method='lu') 4096^2", K3=32, K5=32)
def _lu_getri(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    x = _hollow(cuda, 4096, 1)

    def check(out):
        assert bool(out[1]) and _card_residual(x, out[0]) <= 1e-5
    return lambda: inverse(x, method="lu"), check


@_path("inverse(method='lu') FP64 4096^2 (L3 panels)", L3=32, K3=0, K5=0)
def _lu_getri64(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    x = _hollow(cuda, 4096, 1, np.float64)

    def check(out):
        assert bool(out[1]) and _card_residual(x, out[0]) <= 1e-12
    return lambda: inverse(x, method="lu"), check


def _solve(dtype, gate, **kwargs):
    def make(cuda):
        from gpu_matrix_inversion_tpu_torch import solve
        x = _hollow(cuda, 4096, 1, dtype)
        rhs = _rhs(cuda, 4096, 16, dtype=x.dtype)

        def check(out):
            assert bool(out[1])
            assert _backward_error(x, out[0], rhs) <= gate
        return lambda: solve(x, rhs, **kwargs), check
    return make


_path("solve 4096^2 x 16", K3=32, K5=32)(
    _solve(np.float32, 1e-5))
_path("solve FP64 4096^2 x 16 (L3 panels)", L3=32, K3=0, K5=0)(
    _solve(np.float64, 1e-12, method="lu"))
_path("solve 4096^2 x 16, refine_iters=2 (L5 a step)", K3=32, K5=32,
      L5=2)(
    _solve(np.float32, 1e-5, method="lu", refine_iters=2))


def _slogdet(dtype, rtol):
    def make(cuda):
        from gpu_matrix_inversion_tpu_torch import slogdet
        x = _hollow(cuda, 1024, 7, dtype) / 50

        def check(out):
            sign, logabs, ok = out
            want_sign, want_log = np.linalg.slogdet(x.double().cpu().numpy())
            assert bool(ok) and float(sign) == want_sign
            assert abs(float(logabs) - want_log) <= rtol * abs(want_log)
        return lambda: slogdet(x), check
    return make


_path("slogdet 1024^2", K3=8, K5=8)(_slogdet(np.float32, 1e-4))
_path("slogdet FP64 1024^2 (L3 panels)", L3=8, K3=0, K5=0)(
    _slogdet(np.float64, 1e-10))


@_path("lu_inverse_refined 4096^2, cond 1e4", L4=1, L5=1)
def _lu_refined(cuda):
    from gpu_matrix_inversion_tpu_torch.ops.refine import lu_inverse_refined
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        ill_conditioned_matrix)
    x = torch.from_numpy(ill_conditioned_matrix(
        4096, cond=1e4, seed=55, dtype=np.float64)).to(cuda)

    def check(out):
        raw, ok_raw = lu.lu_inverse(x.float())
        r, r_raw = _card_residual(x, out[0]), _card_residual(x, raw)
        assert bool(out[1]) and bool(ok_raw)
        assert r < 1e-10 and r < r_raw / 10
    return (lambda: lu_inverse_refined(x, iters=4,
                                       residual_dtype=torch.float64), check)


def _lu_batch(cuda):
    return torch.stack([_hollow(cuda, 128, s) for s in range(64)])


@_path("inverse(method='lu') (64, 128^2) (spec)", L4=1, L5=1)
def _lu_spec_batch(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    x = _lu_batch(cuda)

    def check(out):
        assert bool(out[1].all()) and _card_residual(x, out[0]) <= 1e-5
    return lambda: inverse(x, method="lu"), check


@_path("slogdet (64, 128^2) (spec)", L4=1)
def _slogdet_batch(cuda):
    from gpu_matrix_inversion_tpu_torch import slogdet
    x = _lu_batch(cuda)

    def check(out):
        sign, logabs, ok = out
        want_sign, want_log = np.linalg.slogdet(x.double().cpu().numpy())
        assert bool(ok.all())
        assert np.array_equal(sign.cpu().numpy(), want_sign)
        assert (np.abs(logabs.cpu().numpy() - want_log).max()
                <= 1e-4 * np.abs(want_log).max())
    return lambda: slogdet(x), check


@_path("K7 as the verification GEMM of the raw 4096^2 inverse", K7=1)
def _verification_gemm(cuda):
    """A @ X through K7 in fp32; the residual from it agrees with
    utils/residual.py's float64 one within 1% (fp32 rounding of A X adds
    about u / sqrt(n) of ||A|| ||X||, far below the raw residual)."""
    from gpu_matrix_inversion_tpu_torch.ops import matmul
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    x = _hollow(cuda, 4096, 1)
    raw, _ = blocked.blocked_inverse(x, refine=0)

    def check(prod):
        eye = torch.eye(4096, dtype=torch.float64, device=cuda)
        r_k7 = float(torch.linalg.matrix_norm(prod.double() - eye)
                     / (torch.linalg.matrix_norm(x.double())
                        * torch.linalg.matrix_norm(raw.double())))
        want = relative_residual(x.cpu().numpy(), raw.cpu().numpy())
        assert abs(r_k7 - want) <= 1e-2 * want
    return lambda: matmul.tiled_matmul(x, raw), check


@_path("Inverter(method='blocked', refine_iters=1) 4096^2", K2=32)
def _inverter_blocked(cuda):
    from gpu_matrix_inversion_tpu_torch import Inverter
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    a = hollow_random_matrix(4096, seed=1)

    def check(out):
        assert bool(out[1]) and _card_residual(a, out[0]) <= 1e-6
    return (lambda: Inverter(method="blocked", refine_iters=1).inverse(a),
            check)


def _twins() -> tuple:
    """The plain loops L1 to L5 stand in for on the CPU, counted by calls."""
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    return (gauss_jordan.gauss_jordan_twin, blocked.logical_panel_twin,
            lu.lu_panel_twin, lu.lu_factor_twin, lu.lu_solve_twin)


@pytest.mark.parametrize("path", list(PATHS))
def test_path_launches_its_kernels_and_meets_its_gate(cuda, path):
    """Each path of the public API on the card at the main path's and the
    benchmark's shapes, its first call from an empty graph cache (whose
    eager warm-up the wrappers count): it launches its kernels as often
    as its panels ask (and some kernels not at all), runs none of the
    plain loops L1 to L5 replace, and meets its residual gate."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    make, want = PATHS[path]
    call, check = make(cuda)
    twins = _twins()
    for t in twins:
        t.calls = 0
    graphs.clear()
    before = _counts()
    out = call()
    torch.cuda.synchronize()
    grown = _grown(before)
    assert {k: grown.get(k, 0) for k in want} == want, grown
    assert not any(t.calls for t in twins)
    check(out)


@pytest.mark.parametrize("probe", [
    "order 0", "non-square length", "all-ones singular", "NaN input",
    "no pivot on a zero diagonal"])
def test_flat_api_returns_empty_on_the_card(cuda, probe):
    """The flat API's contract on the card: an input it cannot invert
    gives an empty array, never an exception."""
    from gpu_matrix_inversion_tpu_torch import (
        matrix_inv_32, matrix_inversion_no_pivots)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    nan_in = hollow_random_matrix(64, seed=3)
    nan_in[5, 7] = np.nan
    fn, flat, order = {
        "order 0": (matrix_inv_32, [1.0, 2.0, 3.0, 4.0], 0),
        "non-square length": (matrix_inv_32, [1.0, 2.0, 3.0], 2),
        "all-ones singular": (matrix_inv_32, np.ones(64 * 64, np.float32),
                              64),
        "NaN input": (matrix_inv_32, nan_in.reshape(-1), 64),
        "no pivot on a zero diagonal": (
            matrix_inversion_no_pivots, hollow_random_matrix(
                1024, seed=5, dtype=np.float64).reshape(-1), 1024),
    }[probe]
    assert fn(flat, order, device="cuda").size == 0


def _spd(cuda, n, seed, batch=()):
    """G G^T / n + I (G standard normal from ``seed``; condition number at
    most 5), the product in float64 on the card, cast to fp32."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (*batch, n, n))).to(cuda)
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    return (g @ g.mT / n + eye).float()


@pytest.mark.parametrize("n", [1024, 4096, 8192])
def test_potri_on_card(cuda, n):
    """potri under the SPD tier's residual gate (1e-6), bit-identical
    through inverse(method="cholesky") and with a random upper triangle
    (only the lower is read); one diagonal entry set to -50 gives ok
    False, no exception."""
    from gpu_matrix_inversion_tpu_torch import cholesky_inverse, inverse
    x = _spd(cuda, n, seed=n)
    inv, ok = cholesky_inverse(x)
    assert bool(ok) and _card_residual(x, inv) <= 1e-6
    inv2, ok2 = inverse(x, method="cholesky")
    assert bool(ok2) and torch.equal(inv, inv2)
    junk = x + torch.triu(torch.empty_like(x).uniform_(-50.0, 50.0), 1)
    inv3, ok3 = cholesky_inverse(junk)
    assert bool(ok3) and torch.equal(inv, inv3)
    bad = x.clone()
    bad[517, 517] = -50.0
    _, ok_bad = cholesky_inverse(bad)
    assert not bool(ok_bad)


def test_cholesky_route_on_card(cuda):
    """The rest of the Cholesky route at 4096^2: potrf within 1e-5
    (relative Frobenius) of float64 numpy; solve(refine_iters=1) within
    1e-5 in backward error, its x unchanged by a junk upper triangle;
    Inverter(method="cholesky", refine_iters=1) <= 1e-6; an (8, 512^2)
    batch, each member <= 1e-6; an indefinite input gives ok false from
    potrf and potri and an empty vector from the flat API."""
    from gpu_matrix_inversion_tpu_torch import (
        Inverter, api, cholesky_factor, cholesky_inverse, solve)
    x = _spd(cuda, 4096, seed=4096)
    low, ok = cholesky_factor(x)
    want = np.linalg.cholesky(x.double().cpu().numpy())
    assert bool(ok) and (np.linalg.norm(low.double().cpu().numpy() - want)
                         <= 1e-5 * np.linalg.norm(want))
    rhs = _rhs(cuda, 4096, 16)
    sol, ok = solve(x, rhs, method="cholesky", refine_iters=1)
    assert bool(ok) and _backward_error(x, sol, rhs) <= 1e-5
    junk = x + torch.triu(torch.empty_like(x).uniform_(-50.0, 50.0), 1)
    sol_j, _ = solve(junk, rhs, method="cholesky", refine_iters=1)
    assert torch.equal(sol_j, sol)
    inv, ok = Inverter(method="cholesky", refine_iters=1).inverse(x)
    assert bool(ok) and _card_residual(x, inv) <= 1e-6
    batch = _spd(cuda, 512, seed=512, batch=(8,))
    inv_b, ok_b = cholesky_inverse(batch)
    assert bool(ok_b.all()) and _card_residual(batch, inv_b) <= 1e-6
    bad = _spd(cuda, 1024, seed=1024)
    bad[517, 517] = -50.0
    assert not bool(cholesky_inverse(bad)[1])
    assert not bool(cholesky_factor(bad)[1])
    flat = api._invert_flat(bad.cpu().numpy().reshape(-1), 1024, np.float32,
                            pivot=True, device="cuda", method="cholesky")
    assert flat.size == 0


def test_allocator_poison_control(cuda):
    """check_deterministic's allocator poison reaches the block the next
    allocation reuses: an uninitialised torch.empty comes back NaN in the
    second run, so the check reports drift."""
    from gpu_matrix_inversion_tpu_torch.utils import determinism
    # The first run reads a cached block filled with zeros, not the poison
    # an earlier check may have left there.
    scratch = torch.empty(1 << 22, device=cuda)
    del scratch
    determinism.poison_allocator(cuda, 0)
    identical, _ = determinism.check_deterministic(
        lambda: torch.empty(1 << 22, device=cuda), runs=3)
    assert not identical
    x = _spd(cuda, 256, seed=3)
    assert determinism.check_deterministic(lambda t: t @ t, x, runs=3)[0]
    held = torch.empty(3 << 20, dtype=torch.uint8, device=cuda)
    del held
    assert determinism.poison_allocator(cuda) >= 3 << 20
    again = torch.empty(3 << 20, dtype=torch.uint8, device=cuda)
    assert bool((again == 0xFF).all())


def test_shared_memory_poison_reaches_every_sm(cuda):
    """The poison kernel launches at the card's largest dynamic shared
    memory a block may take (227 KiB on Hopper) and reaches every SM."""
    from gpu_matrix_inversion_tpu_torch.utils import determinism
    before = determinism.poison_shared_memory.launches
    sms, smem = determinism.poison_shared_memory(cuda)
    torch.cuda.synchronize()
    props = torch.cuda.get_device_properties(cuda)
    assert sms == props.multi_processor_count
    assert smem >= 227 * 1024
    assert determinism.poison_shared_memory.launches == before + 1


def _normal(cuda, *shape, dtype=torch.float32):
    rng = np.random.default_rng(sum(shape))
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(cuda)


def _sharded_4096(cuda):
    from gpu_matrix_inversion_tpu_torch import parallel
    x, mesh = _hollow(cuda, 4096, 1), parallel.make_device_mesh(1, ("x",))
    return lambda: parallel.sharded_blocked_inverse(x, mesh=mesh)


def _sharded_dp_only(cuda):
    from gpu_matrix_inversion_tpu_torch import parallel
    x = _normal(cuda, 4096, 128, 128)
    mesh = parallel.make_device_mesh((1, 1), ("dp", "tp"))
    return lambda: parallel.sharded_batched_inverse(x, mesh=mesh)


def _call(fn, *makers, **kwargs):
    """make(cuda) of ``fn`` called on the inputs the makers give (each
    ``maker(cuda)``), then on the arguments that are not tensors."""
    def make(cuda):
        inputs = [m(cuda) for m in makers]
        return lambda: fn(*inputs, **kwargs)
    return make


def _shape(*shape, dtype=torch.float32):
    return lambda cuda: _normal(cuda, *shape, dtype=dtype)


def _mask(*shape):
    """An empty used-row mask."""
    return lambda cuda: torch.zeros(shape, dtype=torch.int32, device=cuda)


def _h(n, seed, dtype=np.float32):
    return lambda cuda: _hollow(cuda, n, seed, dtype)


def _zero(cuda):
    return 0


def _l5(rhs):
    """make(cuda) of L5 on L4's factor of a hollow 4096^2 matrix."""
    def make(cuda):
        fac, perm, _ = lu._lu_factor_batched(_hollow(cuda, 4096, 1)[None],
                                             pivot=True)
        b = rhs(cuda)
        return lambda: lu._lu_solve_batched(fac, perm, b)
    return make


def _well_conditioned(cuda):
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        well_conditioned_matrix)
    return torch.from_numpy(well_conditioned_matrix(4096, seed=4096)).to(cuda)


# Each kernel at its main path's shape, then each route: (runs, make(cuda)
# -> the call). The split and the FP64 routes, and L4's grid branch, take
# two runs. The sharded calls run on a world of one rank over NCCL, the
# lockstep call with MATINV_LOCKSTEP=1.
_F64 = torch.float64
_BF16 = torch.bfloat16
POISONED = {
    "K1 (4096, 128^2)": (3, _call(fused.gj_kernel, _shape(4096, 128, 128),
                                  pivot=True)),
    "K1 (512, 256^2)": (3, _call(fused.gj_kernel, _shape(512, 256, 256),
                                 pivot=True)),
    "K2 (4096, 128)": (3, _call(blocked.panel_factor, _shape(128, 4096),
                                _zero, _mask(4096), pivot=True)),
    "K3 (20032, 64) bf16": (3, _call(blocked.pivot_search,
                                     _shape(64, 20032, dtype=_BF16),
                                     _mask(20032))),
    "K4 b=128 x 256": (3, _call(blocked.invert_small, _shape(256, 128, 128),
                                pivot=True)),
    "K5 b=128 x 256": (3, _call(lu.small_lu, lambda cuda: _normal(
        cuda, 256, 128, 128) + 128 * torch.eye(128, device=cuda))),
    "K6 k=8 (1024, 128)": (3, _call(lockstep.lockstep_factor,
                                    _shape(8, 128, 1024), _zero,
                                    _mask(8, 1024), pivot=True)),
    "K7 4096^3 fp32": (3, _call(matmul.tiled_matmul, _shape(4096, 4096),
                                _shape(4096, 4096))),
    "K7 4096^3 bf16": (3, _call(matmul.tiled_matmul,
                                _shape(4096, 4096, dtype=_BF16),
                                _shape(4096, 4096, dtype=_BF16))),
    "L1 (64, 256^2) fp64": (3, _call(gauss_jordan._gauss_jordan_aug,
                                     _shape(64, 256, 256, dtype=_F64),
                                     pivot=True)),
    "L1 (1, 1000^2) fp64 (grid branch)": (3, _call(
        gauss_jordan._gauss_jordan_aug, _shape(1, 1000, 1000, dtype=_F64),
        pivot=True)),
    "L2 (8192, 256) fp64": (3, _call(blocked._panel_pivots_logical,
                                     _shape(8192, 256, dtype=_F64),
                                     _mask(8192), _zero, b=256, pivot=True)),
    "L3 (4096, 128) fp64": (3, _call(lu._lu_panel,
                                     _shape(4096, 128, dtype=_F64),
                                     _mask(4096), _zero, b=128, pivot=True)),
    "L4 (64, 128^2) fp32": (3, _call(lu._lu_factor_batched,
                                     _shape(64, 128, 128), pivot=True)),
    "L4 (1, 4096^2) fp32 (grid branch)": (2, _call(
        lu._lu_factor_batched, lambda cuda: _hollow(cuda, 4096, 1)[None],
        pivot=True)),
    "L5 (1, 4096^2) k = 16": (3, _l5(lambda cuda: _rhs(cuda, 4096,
                                                       16)[None])),
    "L5 (1, 4096^2) k = 4096": (3, _l5(
        lambda cuda: torch.eye(4096, device=cuda)[None])),
    "fused inverse (4096, 128^2)": (3, _call(tpkg.inverse,
                                             _shape(4096, 128, 128))),
    "blocked 4096^2 refined": (3, _call(tpkg.inverse, _h(4096, 1))),
    "bf16 search 4096^2": (3, _call(tpkg.inverse, _h(4096, 1),
                                    search_bf16=True)),
    "split 20000^2": (2, _call(tpkg.inverse, _h(20000, 20000))),
    "FP64 4096^2": (2, _call(tpkg.inverse, _h(4096, 1, np.float64))),
    "FP64 8192^2": (2, _call(tpkg.inverse, _h(8192, 3, np.float64))),
    "no-pivot FP64 4096^2": (2, _call(
        tpkg.inverse, lambda cuda: _dominant(cuda, 4096, 6), pivot=False)),
    "spec FP64 (64, 256^2)": (3, _call(tpkg.inverse,
                                       _shape(64, 256, 256, dtype=_F64))),
    "LU getri 4096^2": (3, _call(tpkg.inverse, _h(4096, 1), method="lu")),
    "FP64 LU getri 4096^2": (2, _call(tpkg.inverse, _h(4096, 1, np.float64),
                                      method="lu")),
    "LU solve 4096^2 x 16": (3, _call(tpkg.solve, _h(4096, 1),
                                      lambda cuda: _rhs(cuda, 4096, 16))),
    "LU solve 4096^2 x 16, refine_iters=2": (3, _call(
        tpkg.solve, _h(4096, 1), lambda cuda: _rhs(cuda, 4096, 16),
        method="lu", refine_iters=2)),
    "lu_inverse_refined 4096^2": (2, _call(
        lu_inverse_refined, _h(4096, 1, np.float64), iters=4,
        residual_dtype=_F64)),
    "LU spec inverse (64, 128^2)": (3, _call(tpkg.inverse, _lu_batch,
                                             method="lu")),
    "lockstep (16, 1024^2)": (3, _call(tpkg.inverse, lambda cuda: torch.stack(
        [_hollow(cuda, 1024, 1024 + i) for i in range(16)]))),
    "Newton-Schulz 4096^2": (3, _call(tpkg.inverse, _well_conditioned,
                                      method="ns")),
    "Cholesky potri 4096^2": (3, _call(
        tpkg.cholesky_inverse, lambda cuda: _spd(cuda, 4096, 4096))),
    "sharded 4096^2 (NCCL, 1-D mesh)": (3, _sharded_4096),
    "sharded dp-only (4096, 128^2) (NCCL, (1, 1) mesh)": (3, _sharded_dp_only),
}


@pytest.mark.parametrize("case", list(POISONED))
def test_poisoned_runs_are_identical(cuda, request, monkeypatch, case):
    """check_deterministic with the caching allocator's free blocks, the
    graphs' pool and every SM's shared memory filled with 0xFF before each
    run after the first (a read of scratch, output or shared memory before
    it is written then drifts), over each kernel K1 to K7 and L1 to L5 and
    each route: the first, eager run and the captured and replayed ones
    bit-identical, and shared memory poisoned before every repeat."""
    from gpu_matrix_inversion_tpu_torch.utils import determinism
    runs, make = POISONED[case]
    if case.startswith("sharded"):
        request.getfixturevalue("nccl_world")
    if case.startswith("lockstep"):
        monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    call = make(cuda)
    before = determinism.poison_shared_memory.launches
    same, diff = determinism.check_deterministic(call, runs=runs)
    assert same, diff
    assert determinism.poison_shared_memory.launches - before == runs - 1


def test_measure_phases_adds_up_on_card(cuda):
    """measure_phases(1024): the five keys; the four slots add up to
    total_compute, the call's device time in the same profiled sessions,
    within 1%; the pivot slot holds K2's device time in the call (the
    ranges catch kernels launched through ctypes); total_compute within
    5% of the call profiled in another session (the profiler's spread
    between sessions reached 2% on the H100)."""
    from gpu_matrix_inversion_tpu_torch.benchmarks.phases import (
        SLOTS, measure_phases)
    from gpu_matrix_inversion_tpu_torch.ops.blocked import blocked_inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.profiling import device_ms
    got = measure_phases(1024, device=cuda)
    assert set(got) == {*SLOTS, "total_compute"}
    assert got["pivot"] > 0 and got["column"] > 0
    a = torch.from_numpy(hollow_random_matrix(1024, seed=0)).to(cuda)
    call_ms = device_ms(lambda: blocked_inverse(a, block_size=128, refine=0),
                        iters=3)
    k2_ms = device_ms(lambda: blocked_inverse(a, block_size=128, refine=0),
                      iters=3, name="panel_factor")
    assert got["pivot"] * 1e3 >= 0.9 * k2_ms
    total = got["total_compute"]
    assert abs(sum(got[k] for k in SLOTS) - total) <= 0.01 * total
    assert abs(total * 1e3 - call_ms) <= 0.05 * call_ms


def test_trace_records_cuda_activity(cuda, tmp_path):
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.profiling import trace
    x = _spd(cuda, 512, seed=5)
    with trace(tmp_path, device=cuda):
        inverse(x, method="blocked")
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    import json
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("panel_factor" in k for k in kernels)


def test_device_ms_reads_every_launch(cuda):
    """device_ms brackets its session with marker kernels, so the record
    the profiler can lose at a session's edge is a marker's: ten 4096^3
    FP32 GEMMs read within 2% of CUDA events (one lost GEMM record would
    read 10% low)."""
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_ms, events_ms)
    g = torch.randn(4096, 4096, device=cuda)
    with matmul_precision("highest"):
        ev = events_ms(lambda: g @ g, iters=10)
        dv = device_ms(lambda: g @ g, iters=10)
    assert dv is not None and abs(dv - ev) <= 0.02 * ev


@pytest.fixture(scope="module")
def nccl_world():
    """A world of one rank over NCCL (a FileStore in a temporary
    directory); destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from gpu_matrix_inversion_tpu_torch.parallel.launch import world
    with world("nccl", timeout=300):
        yield dist


def test_sharded_4096_equals_blocked_bit_for_bit(cuda, nccl_world):
    """World size 1 over NCCL at the production geometry (b = 128,
    group 12: 3 groups): every operation is the blocked route's, so the
    refined result is bit for bit ``blocked_inverse`` at group 12; K2 runs,
    and 5 collectives (3 strips, the slot gather, the ok reduction)."""
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded, sharded_blocked_inverse)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    mesh = make_device_mesh(1, ("x",))
    assert mesh.device_type == "cuda" and nccl_world.get_backend() == "nccl"
    a = hollow_random_matrix(4096, seed=1)
    x = torch.from_numpy(a).to(cuda)
    k2, calls = blocked.panel_factor.launches, sharded.collective.calls
    inv, ok = sharded_blocked_inverse(x, mesh=mesh)
    assert blocked.panel_factor.launches - k2 == 32
    assert sharded.collective.calls - calls == 5
    want, ok_b = blocked.blocked_inverse(x, block_size=128, group_size=12)
    assert bool(ok) and bool(ok_b)
    assert torch.equal(inv.view(torch.int32), want.view(torch.int32))
    assert relative_residual(a, inv.cpu().numpy()) <= 1e-6


def test_sharded_split_equals_blocked_bit_for_bit(cuda, nccl_world):
    """World size 1 over NCCL at 20000^2 (the split geometry: b = 64,
    group 24, 14 groups): bit for bit ``blocked_inverse`` at group 24; K3
    and K4 run, and 16 collectives (14 strips, the slot gather, the ok
    reduction); refined residual <= 1e-6."""
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded, sharded_blocked_inverse)
    mesh = make_device_mesh(1, ("x",))
    x = _hollow(cuda, 20000, 20000)
    before, calls = _counts(), sharded.collective.calls
    inv, ok = sharded_blocked_inverse(x, mesh=mesh)
    assert _grown(before) == {"K3": 313, "K4": 313}
    assert sharded.collective.calls - calls == 16
    want, ok_b = blocked.blocked_inverse(x, group_size=24)
    assert bool(ok) and bool(ok_b)
    assert torch.equal(inv.view(torch.int32), want.view(torch.int32))
    assert _card_residual(x, inv) <= 1e-6


def test_auto_routes_32768_to_sharded(cuda, nccl_world):
    """With a mesh, ``inverse`` routes a 32768^2 matrix (past the blocked
    route's reach on one card) to the sharded route (b = 64, group 24: 21
    groups and a tail of 8, 512 panels): 512 K3 and 512 K4 launches, 24
    collectives, refined residual <= 1e-6 (in float64 on the card, a
    column block at a time)."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.models import solver
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded)
    mesh = make_device_mesh(1, ("x",))
    n = 32768
    x = _hollow(cuda, n, n)
    assert solver._resolve("auto", x, mesh) == "sharded"
    before, calls = _counts(), sharded.collective.calls
    inv, ok = inverse(x, mesh=mesh)
    assert _grown(before) == {"K3": 512, "K4": 512}
    assert sharded.collective.calls - calls == 24
    assert bool(ok)
    sq, a64 = 0.0, x.double()
    for j in range(0, n, 4096):
        blk = a64 @ inv[:, j:j + 4096].double()
        blk[j:j + 4096].diagonal().sub_(1.0)
        sq += float((blk * blk).sum())
        del blk
    assert sq ** 0.5 <= 1e-6 * (
        float(torch.linalg.vector_norm(x, dtype=torch.float64))
        * float(torch.linalg.vector_norm(inv, dtype=torch.float64)))


@pytest.mark.parametrize("bsz", [64, 4096])
def test_sharded_dp_only_batch_equals_fused(cuda, nccl_world, bsz):
    """A (1, 1) (dp, tp) cuda mesh with n <= 640 runs K1 on the local
    batch (up to the main path's 4096 matrices): bit for bit
    ``fused_inverse``; a singular member's ok alone false."""
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded_batched_inverse)
    mesh = make_device_mesh((1, 1), ("dp", "tp"))
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((bsz, 128, 128)).astype(
        np.float32)).to(cuda)
    x[5] = 1.0
    k1 = fused.gj_kernel.launches
    inv, ok = sharded_batched_inverse(x, mesh=mesh)
    assert fused.gj_kernel.launches - k1 == 1
    want, ok_f = fused.fused_inverse(x)
    assert torch.equal(inv.view(torch.int32), want.view(torch.int32))
    assert ok.tolist() == ok_f.tolist() and ok.tolist().count(False) == 1


def test_inverse_method_sharded_on_a_cuda_mesh(cuda, nccl_world):
    """``inverse(method="sharded", mesh=)`` and ``Inverter(mesh=)`` on a
    cuda mesh: the sharded call's result, under the refined gate; a batch
    goes through the panel body, bit for bit the raw blocked route."""
    from gpu_matrix_inversion_tpu_torch import Inverter, inverse
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded_blocked_inverse)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    mesh = make_device_mesh(1, ("x",))
    a = hollow_random_matrix(1024, seed=9)
    x = torch.from_numpy(a).to(cuda)
    inv, ok = inverse(x, method="sharded", mesh=mesh)
    want, _ = sharded_blocked_inverse(x, mesh=mesh)
    assert bool(ok) and torch.equal(inv, want)
    assert relative_residual(a, inv.cpu().numpy()) <= 1e-6
    inv2, ok2 = Inverter(method="sharded", mesh=mesh).inverse(a)
    assert bool(ok2) and inv2.device.type == "cuda"
    mesh2 = make_device_mesh((1, 1), ("dp", "tp"))
    batch = torch.stack([x, x.t().contiguous()])
    invb, okb = inverse(batch, method="sharded", mesh=mesh2)
    wantb, _ = blocked.blocked_inverse(batch, block_size=128, group_size=8,
                                       refine=0)
    assert bool(okb.all())
    assert torch.equal(invb.view(torch.int32), wantb.view(torch.int32))


def test_sharded_input_and_mesh_share_a_device(cuda, nccl_world):
    """The sharded route never moves its input: a CPU tensor with a cuda
    mesh (``solve`` included), or with no mesh under an NCCL world, raises
    ValueError; a card tensor with no mesh runs on a mesh of the world on
    its own device."""
    from gpu_matrix_inversion_tpu_torch import solve
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded_blocked_inverse)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    mesh = make_device_mesh(1, ("x",))
    a = torch.from_numpy(hollow_random_matrix(256, seed=3))
    with pytest.raises(ValueError, match="mesh"):
        solve(a, torch.ones(256), method="sharded", mesh=mesh)
    with pytest.raises(ValueError, match="does not serve"):
        sharded_blocked_inverse(a)
    inv, ok = sharded_blocked_inverse(a.to(cuda))
    want, _ = sharded_blocked_inverse(a.to(cuda), mesh=mesh)
    assert bool(ok) and inv.device == cuda and torch.equal(inv, want)


def test_multichip_example_on_the_cards(cuda):
    """``examples/torch_04_multichip.py`` with no argument and no torchrun
    spawns one NCCL rank per card (``spawn_ranks``' cuda branch): world
    size 1 on one card, the dp x tp call on a (1, 1) mesh."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "examples",
                                      "torch_04_multichip.py")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"world of {torch.cuda.device_count()} cuda ranks" in r.stdout
    assert "sharded ok: True" in r.stdout and "dp x tp ok: True" in r.stdout


# --------------------------------------------------------------------------
# The compiled routes: CUDA graphs captured once and replayed
# --------------------------------------------------------------------------


@pytest.fixture
def graph_cache(cuda):
    """An empty graph cache on the card, emptied again afterwards."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    graphs.clear()
    yield graphs
    graphs.clear()


def _wrappers() -> dict:
    from gpu_matrix_inversion_tpu_torch.ops import lockstep, matmul
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    return {"K1": fused.gj_kernel, "K2": blocked.panel_factor,
            "K3": blocked.pivot_search, "K4": blocked.invert_small,
            "K5": lu.small_lu, "K6": lockstep.lockstep_factor,
            "K7": matmul.tiled_matmul,
            "L1": gauss_jordan._gauss_jordan_aug,
            "L2": blocked._panel_pivots_logical, "L3": lu._lu_panel,
            "L4": lu._lu_factor_batched, "L5": lu._lu_solve_batched}


def _counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def _grown(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _as_records(counts: dict) -> dict:
    """Wrapper counts as the profiler sees them: K2 and K6 launch one
    kernel (profiling.KERNEL_NAMES)."""
    out = {}
    for k, n in counts.items():
        key = "K2/K6" if k in ("K2", "K6") else k
        out[key] = out.get(key, 0) + n
    return out


def _records(call) -> dict:
    """The port's kernels one call of ``call`` ran on the card, from the
    profiler's kernel records."""
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_kernels, kernel_launches)
    return kernel_launches(device_kernels(call))


def _nodes(last: int) -> dict:
    """The port's kernels the ``last`` graphs used hold as nodes."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        kernel_launches)
    return kernel_launches([(k, n, 0.0) for k, n in
                            graphs.kernel_nodes(last).items()])


def _at_most(recorded: dict, want: dict) -> bool:
    """The profiler can drop a kernel's record and never adds one: its
    count of each kernel is at most the exact one."""
    return all(n <= want.get(k, 0) for k, n in recorded.items())


def _route_calls(cuda):
    """Each compiled route at a small shape: (name, the compiled functions
    it calls, by their names in graphs.stats(), the call on an input A, the
    call on an input B of the same signature)."""
    from gpu_matrix_inversion_tpu_torch import (cholesky_inverse, inverse,
                                                solve)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        well_conditioned_matrix)
    rng = np.random.default_rng(11)

    def pair(make):
        return make(0), make(1)

    h = pair(lambda i: _hollow(cuda, 1024, 5 + 50 * i))
    h64 = pair(lambda i: _hollow(cuda, 512, 6 + 60 * i, np.float64))
    k64 = pair(lambda i: _hollow(cuda, 1024, 7 + 70 * i, np.float64))
    x8k = pair(lambda i: _hollow(cuda, 8192, 4 + 40 * i, np.float64))
    dom = pair(lambda i: _dominant(cuda, 512, 6 + 60 * i))
    small64 = pair(lambda i: _hollow(cuda, 128, 7 + 70 * i, np.float64))
    batch64 = pair(lambda i: torch.stack([
        _hollow(cuda, 256, 100 * i + s, np.float64) for s in range(16)]))
    batch = pair(lambda i: torch.stack([
        _hollow(cuda, 1024, 20 + i + s) for s in range(3)]))
    spd = pair(lambda i: _spd(cuda, 512, 8 + 80 * i))
    wc = pair(lambda i: torch.from_numpy(well_conditioned_matrix(
        512, seed=9 + 90 * i)).to(cuda))
    rhs = pair(lambda i: torch.from_numpy(rng.standard_normal(
        (1024, 4)).astype(np.float32)).to(cuda))
    rhs64 = pair(lambda i: rhs[i].double())
    small = pair(lambda i: torch.stack([
        _hollow(cuda, 128, 30 + 30 * i + s) for s in range(16)]))
    small_rhs = pair(lambda i: torch.from_numpy(rng.standard_normal(
        (16, 128, 3)).astype(np.float32)).to(cuda))
    lu_s, perm_s, _ = lu._lu_factor_batched(small[0], pivot=True)
    lu_fns = ("lu_factor_blocked", "lu_solve_fast")
    routes = {
        "blocked": (("blocked_inverse",), inverse, h),
        "bf16 search": (("blocked_inverse",),
                        lambda x: inverse(x, search_bf16=True), h),
        "FP64 tier": (("blocked_inverse",), inverse, h64),
        "FP64 logical tier 8192^2": (("blocked_inverse",), inverse, x8k),
        "no-pivot FP64": (("blocked_inverse",),
                          lambda x: inverse(x, pivot=False), dom),
        "per-matrix batch": (("blocked_inverse",), inverse, batch),
        "LU getri": (("lu_inverse_fast",),
                     lambda x: inverse(x, method="lu"), h),
        "FP64 LU getri (L3 panels)": (("lu_inverse_fast",),
                                      lambda x: inverse(x, method="lu"), k64),
        "LU solve": (lu_fns, lambda i: solve(h[i], rhs[i]), (0, 1)),
        "FP64 LU solve (L3 panels)": (
            lu_fns, lambda i: solve(k64[i], rhs64[i], method="lu"), (0, 1)),
        "LU solve, refine_iters=2": (
            lu_fns + ("refine_solve",),
            lambda i: solve(h[i], rhs[i], method="lu", refine_iters=2),
            (0, 1)),
        "lu_inverse_refined": (
            ("lu_inverse", "newton_schulz_refine"),
            lambda x: lu_inverse_refined(x, iters=4,
                                         residual_dtype=torch.float64), h64),
        "potri": (("cholesky_inverse",), cholesky_inverse, spd),
        "Cholesky solve": (("cholesky_factor", "cholesky_solve"),
                           lambda i: solve(spd[i], rhs[i][:512],
                                           method="cholesky"), (0, 1)),
        "Newton-Schulz": (("newton_schulz_inverse",),
                          lambda x: inverse(x, method="ns"), wc),
        "spec": (("gauss_jordan_inverse",), inverse, small64),
        "spec FP64 (16, 256^2)": (("gauss_jordan_inverse",), inverse,
                                  batch64),
        "LU spec getrf": (("lu_factor",), lu.lu_factor, small),
        "LU spec getrs": (("lu_solve",),
                          lambda b: lu.lu_solve(lu_s, perm_s, b), small_rhs),
        "LU spec getri": (("lu_inverse",), lu.lu_inverse, small),
        "LU spec solve": (("lu_solve_matrix",),
                          lambda i: lu.lu_solve_matrix(small[i],
                                                       small_rhs[i]), (0, 1)),
        "slogdet (spec)": (("slogdet",), lu.slogdet, small),
        "slogdet FP64 (L3 panels)": (("slogdet",), lu.slogdet, h64),
    }
    return {name: (fns, lambda fn=fn, a=args[0]: fn(a),
                   lambda fn=fn, b=args[1]: fn(b))
            for name, (fns, fn, args) in routes.items()}


def _leaves(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _assert_bits(got, want) -> None:
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _held_through_a_b_a(call_a, call_b) -> None:
    """A, B, A: A's result, held, is unchanged by the replays for B and A,
    and A's second result equals it; B's replay is B's eager bits (the
    graph recomputes every step from its input) and differs from A's."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    with graphs.disabled():
        eager_b = call_b()
    held = call_a()
    keep = tuple(t.clone() for t in _leaves(held))
    other = call_b()
    again = call_a()
    _assert_bits(held, keep)
    _assert_bits(again, held)
    _assert_bits(other, eager_b)
    assert not all(torch.equal(o, k) for o, k in zip(_leaves(other), keep))


ROUTES = [
    "blocked", "bf16 search", "FP64 tier", "FP64 logical tier 8192^2",
    "no-pivot FP64", "per-matrix batch", "LU getri",
    "FP64 LU getri (L3 panels)", "LU solve", "FP64 LU solve (L3 panels)",
    "LU solve, refine_iters=2", "lu_inverse_refined", "potri",
    "Cholesky solve", "Newton-Schulz", "spec", "spec FP64 (16, 256^2)",
    "LU spec getrf", "LU spec getrs", "LU spec getri", "LU spec solve",
    "slogdet (spec)", "slogdet FP64 (L3 panels)"]


@pytest.mark.parametrize("route", ROUTES)
def test_replay_equals_eager(graph_cache, cuda, route):
    """Eager (graphs.disabled()), the first call (the capture) and a
    replay give the same bits, outputs and ok; stats() shows one capture
    of each compiled function the route calls, then replays; a replay runs
    no kernel wrapper; the graphs hold the port's kernels as the wrappers
    counted them eagerly, and the profiler's records show none more often,
    eager or replayed. Then A, B, A leaves A's held result unchanged, and
    check_deterministic (eager, then replays, poisoned between) holds."""
    from gpu_matrix_inversion_tpu_torch.utils import determinism
    graphs = graph_cache
    fns, call, call_b = _route_calls(cuda)[route]
    with graphs.disabled():
        call()                          # builds the kernels, fills caches
        before = _counts()
        eager = call()
        eager_counts = _as_records(_grown(before))
        assert _at_most(_records(call), eager_counts)
    assert graphs.stats() == {}
    first = call()
    assert {fn: graphs.stats()[fn] for fn in fns} == {
        fn: {"captures": 1, "replays": 1} for fn in fns}
    before = _counts()
    replayed = call()
    assert _grown(before) == {}
    assert {fn: graphs.stats()[fn] for fn in fns} == {
        fn: {"captures": 1, "replays": 2} for fn in fns}
    assert _nodes(graphs.cached()) == eager_counts
    assert _at_most(_records(call), eager_counts)
    assert _grown(before) == {}
    _assert_bits(first, eager)
    _assert_bits(replayed, eager)
    _held_through_a_b_a(call, call_b)
    assert determinism.check_deterministic(call, runs=3)[0]


@pytest.mark.parametrize("bsz,n,k6", [(4, 1024, 8), (8, 2048, 32)])
def test_lockstep_replay_equals_eager(graph_cache, cuda, monkeypatch, bsz, n,
                                      k6):
    """The lockstep route (MATINV_LOCKSTEP=1, K6) replayed bit for bit as
    it runs eagerly, its graph holding K6's eager launches; the
    environment variable is part of the key, so the per-matrix graph is
    another. A, B, A leaves A's held result unchanged."""
    from gpu_matrix_inversion_tpu_torch import inverse
    graphs = graph_cache
    x = torch.stack([_hollow(cuda, n, 40 + i) for i in range(bsz)])
    per_matrix = inverse(x)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    with graphs.disabled():
        before = _counts()
        eager = inverse(x)
        eager_counts = _grown(before)
    assert eager_counts.get("K6") == k6
    inverse(x)
    before = _counts()
    replayed = inverse(x)
    assert _grown(before) == {}
    assert graphs.stats()["blocked_inverse"] == {"captures": 2,
                                                 "replays": 3}
    assert _nodes(1) == _as_records(eager_counts)
    assert _at_most(_records(lambda: inverse(x)), _as_records(eager_counts))
    _assert_bits(replayed, eager)
    _assert_bits(replayed, per_matrix)
    x_b = x.flip(0).contiguous()
    _held_through_a_b_a(lambda: inverse(x), lambda: inverse(x_b))


def test_held_result_survives_later_replays(graph_cache, cuda):
    """A, B, A: A's first result, still held, is unchanged by the replays
    for B and A, and A's second result equals it."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    a = torch.from_numpy(hollow_random_matrix(1024, seed=50)).to(cuda)
    b = torch.from_numpy(hollow_random_matrix(1024, seed=51)).to(cuda)
    held, ok_held = inverse(a)
    copy = held.clone()
    inv_b, _ = inverse(b)
    again, ok_again = inverse(a)
    assert graph_cache.stats()["blocked_inverse"] == {"captures": 1,
                                                      "replays": 3}
    assert not torch.equal(inv_b, held)
    _assert_bits(held, copy)
    _assert_bits((again, ok_again), (held, ok_held))


def test_capture_that_syncs_the_host_raises(graph_cache, cuda):
    """A compiled body that reads a value on the host fails its capture:
    the call raises, naming the function and its signature, and returns
    no eager result; the cache holds nothing for it, and a later capture
    works."""
    graphs = graph_cache

    @graphs.compiled
    def syncs(x):
        return x * float(x.sum())

    with pytest.raises(graphs.GraphCaptureError,
                       match=r"syncs\(x: \(8,\) float32 cuda:0\)"):
        syncs(torch.ones(8, device=cuda))
    assert "syncs" not in graphs.stats() and not graphs._cache.entries

    @graphs.compiled
    def doubles(x):
        return 2 * x

    assert torch.equal(doubles(torch.ones(8, device=cuda)),
                       torch.full((8,), 2.0, device=cuda))
    assert graphs.stats()["doubles"] == {"captures": 1, "replays": 1}


def test_allocator_poison_reaches_the_graph_pool(graph_cache, cuda):
    """poison_allocator fills the free blocks of the graphs' pool, where a
    replay keeps its scratch, and a poisoned replay keeps its bits."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils import determinism
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    x = torch.from_numpy(hollow_random_matrix(1024, seed=60)).to(cuda)
    first, _ = inverse(x)
    torch.cuda.synchronize()
    determinism.poison_allocator(cuda)
    torch.cuda.synchronize()
    ours = tuple(graph_cache._cache.pools[cuda])
    pooled = [(b["address"], b["size"])
              for seg in torch.cuda.memory_snapshot()
              if tuple(seg["segment_pool_id"]) == ours
              for b in seg["blocks"] if b["state"] == "inactive"]
    assert pooled
    for address, size in pooled:
        assert bool((determinism._over(address, size, cuda) == 0xFF).all())
    assert graph_cache.pool_bytes() >= sum(size for _, size in pooled)
    again, _ = inverse(x)
    _assert_bits(again, first)
    same, _ = determinism.check_deterministic(inverse, x, runs=3)
    assert same


def test_nested_call_past_the_gate_runs_inline(graph_cache, cuda,
                                               monkeypatch):
    """A call past the gate runs eagerly, and so do the compiled calls it
    makes (the per-matrix polish): nothing is captured."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    graphs = graph_cache
    monkeypatch.setattr(graphs, "GATE_ELEMENTS", 1024 * 1024)
    x = torch.from_numpy(np.stack([hollow_random_matrix(1024, seed=70 + i)
                                   for i in range(2)])).to(cuda)
    inv, ok = inverse(x)
    assert bool(ok.all()) and graphs.stats() == {} and graphs.cached() == 0
    with graphs.disabled():
        _assert_bits(inverse(x), (inv, ok))


def test_cache_keeps_the_graphs_used_last(graph_cache, cuda, monkeypatch):
    """Past MAX_GRAPHS the graph used least recently goes; its signature
    captures again."""
    graphs = graph_cache
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)

    @graphs.compiled
    def twice(x):
        return 2 * x

    xs = [torch.ones(n, device=cuda) for n in (8, 16, 32)]
    for x in xs[:2] + xs[:1] + xs[2:]:
        _assert_bits(twice(x), 2 * x)
    assert graphs.cached() == 2
    assert graphs.stats()["twice"] == {"captures": 3, "replays": 4}
    _assert_bits(twice(xs[0]), 2 * xs[0])          # kept: used third
    _assert_bits(twice(xs[1]), 2 * xs[1])          # dropped: captured again
    assert graphs.stats()["twice"] == {"captures": 4, "replays": 6}
    assert graphs.cached() == 2


def test_the_sweep_sizes_keep_the_graphs_used_last(graph_cache, cuda):
    """The sweep's sizes past the fused route (650 .. 2000 in steps of
    10), one blocked_inverse graph a size: each ok, each captured once,
    and the cache holds the MAX_GRAPHS used last."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.benchmarks.sweep import (
        reference_sizes)
    sizes = [n for n in reference_sizes(2000) if n > fused.FUSED_MAX_N]
    for n in sizes:
        x = torch.rand(n, n, device=cuda)
        x.fill_diagonal_(0.0)
        assert bool(inverse(x)[1]), n
    assert graph_cache.cached() == min(len(sizes), graph_cache.MAX_GRAPHS)
    assert graph_cache.stats()["blocked_inverse"]["captures"] == len(sizes)


def test_sweep_rows_meet_their_gates(cuda):
    """The sweep CLI's rows on the card: auto at 256 (fused), 1024 and
    4096 (blocked) and potri at 4096 on SPD input, each row's normalized
    residual (its eighth field) under the route's gate."""
    import io
    from gpu_matrix_inversion_tpu_torch.benchmarks.sweep import sweep_cuda
    rows = io.StringIO()
    sweep_cuda(0, rows, sizes=[256, 1024, 4096], method="auto")
    sweep_cuda(0, rows, sizes=[4096], method="cholesky", spd=True)
    lines = rows.getvalue().splitlines()
    assert len(lines) == 4
    for row, gate in zip(lines, (1e-5, 1e-6, 1e-6, 1e-6)):
        assert float(row.split()[7]) <= gate, row


def test_trace_of_a_replayed_route_shows_the_phase_ranges(graph_cache, cuda,
                                                          tmp_path):
    """trace() of a route whose graph is cached runs it eagerly, so the
    operator trace holds the blocked driver's phase ranges (the FP32
    kernel route's: the augmented matrix and K2's pivot search)."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils import profiling
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    x = torch.from_numpy(hollow_random_matrix(1024, seed=80)).to(cuda)
    want = inverse(x)
    inverse(x)
    stats = graph_cache.stats()
    with profiling.trace(str(tmp_path)):
        got = inverse(x)
    assert graph_cache.stats() == stats
    _assert_bits(got, want)
    text = "".join(f.read_text() for f in tmp_path.rglob("*.json"))
    for name in ("make_augmented", "pivot"):
        assert f"matinv::{name}" in text


def _profiled(call):
    """``prof.events()`` of ``call`` under a CPU and CUDA profiler session,
    synchronized before it closes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof.events()


def test_replay_span_encloses_the_graph_launch(graph_cache, cuda):
    """Under the profiler a second call of the blocked 1024^2 route
    replays the graph the first captured (the spans enter no key):
    captures unchanged, replays up by one. It opens the dispatch's span
    and the cache's four, once each, nested; ``graphs.replay`` holds the
    session's one ``cudaGraphLaunch``."""
    from torch.autograd import DeviceType
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    x = torch.from_numpy(hollow_random_matrix(1024, seed=81)).to(cuda)
    inverse(x)
    torch.cuda.synchronize()
    before = graph_cache.stats()["blocked_inverse"]
    events = _profiled(lambda: inverse(x))
    assert graph_cache.stats()["blocked_inverse"] == {
        "captures": before["captures"], "replays": before["replays"] + 1}
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {e.name: e.time_range for e in host
             if e.name.startswith("matinv::")}
    assert sorted(e.name for e in host if e.name.startswith("matinv::")) \
        == sorted(spans) == [
            "matinv::graphs.copy_in", "matinv::graphs.copy_out",
            "matinv::graphs.key", "matinv::graphs.replay",
            "matinv::solver.inverse"]
    outer = spans["matinv::solver.inverse"]
    assert all(outer.start <= r.start and r.end <= outer.end
               for r in spans.values())
    launches = [e.time_range for e in host
                if e.name.startswith("cudaGraphLaunch")]
    replay = spans["matinv::graphs.replay"]
    assert len(launches) == 1
    assert replay.start <= launches[0].start <= launches[0].end <= replay.end


def test_spans_share_the_device_clock(graph_cache, cuda):
    """Clock check: the first device record of every runtime launch made
    inside a ``matinv::`` span (a replayed blocked 1024^2, a (64, 128^2)
    batch on the fused route, ``matrix_inv_32`` at 512 with its copies)
    starts no earlier than the launch, on the profiler's one clock. Prints
    each session's smallest launch-to-start leads.

    Some profiler sessions put every device record, kernels and copies
    alike, before the host's records (13 of 64 sessions, by up to 3.2 ms;
    H100 80GB HBM3, 700 W): a skew of the whole session, which a reader
    of its gaps must check. So, as a session short of records is, a
    session that fails is profiled again, up to three."""
    from gpu_matrix_inversion_tpu_torch import api, inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.profiling import launch_leads
    x = torch.from_numpy(hollow_random_matrix(1024, seed=82)).to(cuda)
    batch = torch.from_numpy(np.stack([
        hollow_random_matrix(128, seed=90 + i) for i in range(64)])).to(cuda)
    flat = hollow_random_matrix(512, seed=83).reshape(-1)

    def calls():
        for _ in range(3):
            inverse(x)
            inverse(batch)
            assert api.matrix_inv_32(flat, 512, device=cuda).size == 512**2
    calls()
    for _ in range(3):
        leads = sorted(launch_leads(_profiled(calls)))
        print(f"launch-to-start leads over {len(leads)} launches, smallest: "
              + "; ".join(f"{lead:.3f} us {launch} -> {record}"
                          for lead, launch, record in leads[:3]))
        # K1 and the gather a batch call at least, each launched eagerly.
        assert len(leads) >= 3 * 2
        if leads[0][0] >= 0:
            break
    assert leads[0][0] >= 0


def _zero_sign_differences(x, y) -> int:
    """Elements whose bits differ other than by the sign of a zero."""
    ints = torch.int64 if x.element_size() == 8 else torch.int32
    differ = x.view(ints) != y.view(ints)
    return int((differ & ~((x == 0) & (y == 0))).sum())


# L1 at B in {1, 64} x n in {8, 100, 256 (the FP64 tier's block), 511 (a
# cluster of 16)} on its cluster branch and {640, 1000} on its grid
# branch, fp64 and fp32, with and without pivoting; and on exact ties.
L1_CASES = [(bsz, n, dtype, pivot, "normal")
            for dtype in (torch.float64, torch.float32)
            for n in (8, 100, 256, 511, 640, 1000)
            for bsz in (1, 64) for pivot in (True, False)] + [
    (4, 100, torch.float32, False, "normal"),
    (2, 1000, torch.float64, False, "normal"),
    *((4, n, dtype, True, "integers") for n in (256, 640)
      for dtype in (torch.float64, torch.float32))]


@pytest.mark.parametrize("bsz, n, dtype, pivot, kind", L1_CASES)
def test_l1_matches_twin(cuda, bsz, n, dtype, pivot, kind):
    """L1 (csrc/gauss_jordan.cu) against gauss_jordan_twin on the card:
    the twin's bits up to the sign of a zero, ok equal (all true)."""
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    rng = np.random.default_rng(n + bsz)
    if kind == "integers":
        a = rng.integers(-3, 4, (bsz, n, n)).astype(np.float64)
    else:
        a = rng.standard_normal((bsz, n, n)) + (0 if pivot else n
                                                * np.eye(n))
    x = torch.from_numpy(a).to(dtype).to(cuda)
    inv, ok = gauss_jordan._gauss_jordan_aug(x, pivot=pivot)
    want, want_ok = gauss_jordan.gauss_jordan_twin(x, pivot=pivot)
    assert torch.equal(ok, want_ok)
    assert kind == "integers" or bool(ok.all())
    assert _zero_sign_differences(inv, want) == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [256, 640])
def test_l1_ok_on_singular_and_nan_blocks(cuda, n, dtype):
    """A regular, a singular (a zero row) and a NaN block: ok as the
    twin's, true, false, false."""
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    a = np.random.default_rng(n).standard_normal((3, n, n))
    a[1, 3] = 0.0
    a[2, 7, 9] = np.nan
    x = torch.from_numpy(a).to(dtype).to(cuda)
    ok = gauss_jordan._gauss_jordan_aug(x, pivot=True)[1]
    assert ok.tolist() == [True, False, False]
    assert torch.equal(ok, gauss_jordan.gauss_jordan_twin(x, pivot=True)[1])


@pytest.mark.parametrize("mask", ["empty", "half"])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("m, b, dtype", [
    (512, 64, torch.float64),
    (4096, 256, torch.float64),
    (8192, 256, torch.float64),
    (16384, 256, torch.float64),                  # rows in a workspace
    (65600, 32, torch.float32),
])
def test_l2_matches_twin(cuda, m, b, dtype, pivot, mask):
    """L2 (csrc/logical_panel.cu) against logical_panel_twin on the card:
    pivot rows and ok identical."""
    rng = np.random.default_rng(m + b)
    strip = torch.from_numpy(rng.standard_normal((m, b))).to(dtype).to(cuda)
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    kb = 0
    if mask == "half" and pivot:
        used[torch.from_numpy(rng.permutation(m)[:m // 2]).to(cuda)] = 1
    elif mask == "half":                          # a later no-pivot panel
        used[:m // 2] = 1
        kb = m // 2
    got, ok = blocked._panel_pivots_logical(strip, used, kb, b=b,
                                            pivot=pivot)
    want, want_ok = blocked.logical_panel_twin(strip, used, kb, b=b,
                                               pivot=pivot)
    assert torch.equal(got, want) and bool(ok) == bool(want_ok)


def test_fp64_routes_launch_the_loops(cuda):
    """On the card the FP64 routes run L1 and L2 and never the plain
    loops: FP64 1024^2 (b = 256) K3 and L1 once a panel, no-pivot FP64
    1024^2 L2 and L1 once a panel, an FP64 (8, 128^2) batch (spec) one L1
    launch; each within 1e-12 in residual."""
    from gpu_matrix_inversion_tpu_torch.models.solver import inverse
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    h = hollow_random_matrix(1024, seed=11, dtype=np.float64)
    dom = h + 2 * np.abs(h).sum(axis=1).max() * np.eye(1024)
    batch = np.stack([hollow_random_matrix(128, seed=s, dtype=np.float64)
                      for s in range(8)])
    for a, pivot, want in ((h, True, {"K3": 4, "L1": 4}),
                           (dom, False, {"L2": 4, "L1": 4}),
                           (batch, True, {"L1": 1})):
        gauss_jordan.gauss_jordan_twin.calls = 0
        blocked.logical_panel_twin.calls = 0
        before = _counts()
        inv, ok = inverse(torch.from_numpy(a).to(cuda), pivot=pivot)
        assert _grown(before) == want
        assert gauss_jordan.gauss_jordan_twin.calls == 0
        assert blocked.logical_panel_twin.calls == 0
        assert bool(ok.all())
        x = inv.cpu().numpy()
        for i in range(a.shape[0] if a.ndim == 3 else 1):
            ai, xi = (a[i], x[i]) if a.ndim == 3 else (a, x)
            assert relative_residual(ai, xi) <= 1e-12


# --------------------------------------------------------------------------
# L3, L4 and L5: the LU module's loops
# --------------------------------------------------------------------------


def _same_bits(x, y) -> bool:
    """Bit for bit, except that NaN matches NaN whatever its payload."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if not x.is_floating_point():
        return torch.equal(x, y)
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return torch.equal(x.view(ints)[~nan], y.view(ints)[~nan])


def _lu_members(rng, bsz: int, n: int, kind: str) -> np.ndarray:
    """normal; dominant (no pivoting needed); integers in [-3, 3] (exact
    ties); signed_zeros: integers in [-3, 3] with every zero -0.0 and -0.0
    planted at every third place above the diagonal, beside negative
    values, so that -0 reaches the U rows of later pivots; special: a
    regular member, a singular one (a zero row), one holding a NaN and one
    holding an infinity (as many of these as the batch holds)."""
    if kind in ("integers", "signed_zeros"):
        a = rng.integers(-3, 4, (bsz, n, n)).astype(np.float64)
        if kind == "signed_zeros":
            upper = np.triu(np.ones((n, n), dtype=bool), 1)
            upper &= (np.arange(n)[None, :] % 3) == 0
            a[:, upper] = -0.0
            a[a == 0] = -0.0
        return a
    a = rng.standard_normal((bsz, n, n))
    if kind == "dominant":
        a += n * np.eye(n)
    if kind == "special":
        for i, (row, col, value) in enumerate(
                ((3, slice(None), 0.0), (n // 2, n // 3, np.nan),
                 (n // 3, n // 2, np.inf))[:bsz - 1], start=1):
            a[i, row, col] = value
    return a


def _largest_blocked_n(itemsize: int) -> int:
    """The largest n that lu_factor_plan sends to L4's blocked path."""
    lo, hi = 512, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            lu.lu_factor_plan(1, mid, itemsize)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


L4_FP64_MAX_N = _largest_blocked_n(8)


@pytest.mark.parametrize("bsz, n, dtype, pivot, kind", [
    (64, 128, torch.float32, True, "normal"),     # the small-n LU batch
    (1, 200, torch.float64, True, "normal"),
    (1, 130, torch.float32, False, "dominant"),
    (4, 256, torch.float64, True, "integers"),    # exact ties
    (4, 100, torch.float64, True, "special"),
    (1, 640, torch.float32, True, "normal"),      # the grid branch
    (4, 600, torch.float64, True, "special"),
    (1, 2000, torch.float64, False, "dominant"),  # rows in a workspace
    (1, 200, torch.float64, False, "dominant"),
    (4, 200, torch.float64, True, "special"),
    (4, 130, torch.float32, True, "special"),
    (1, 4096, torch.float32, True, "normal"),     # lu_inverse_refined's
    (1, 640, torch.float32, True, "integers"),    # ties on the blocked path
    (1, 640, torch.float32, True, "signed_zeros"),
    (2, 600, torch.float64, True, "signed_zeros"),
    (1, 700, torch.float32, False, "signed_zeros"),
    (1, 512, torch.float32, True, "normal"),      # the smallest blocked n
    (1, 1000, torch.float32, True, "normal"),     # n off the panel width
    (3, 600, torch.float32, True, "special"),     # a batch of three
    (1, L4_FP64_MAX_N, torch.float64, True, "normal"),  # fp64's largest
])
def test_l4_matches_twin(cuda, bsz, n, dtype, pivot, kind):
    """L4 (csrc/gauss_jordan.cu's LU mode to n = 511, the blocked
    csrc/lu_factor.cu past it) against lu_factor_twin on the card: the
    factor's bits, perm and ok identical."""
    a = _lu_members(np.random.default_rng(n + bsz), bsz, n, kind)
    x = torch.from_numpy(a).to(dtype).to(cuda)
    got = lu._lu_factor_batched(x, pivot=pivot)
    want = lu.lu_factor_twin(x, pivot=pivot)
    assert _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if kind == "special":
        assert got[2].tolist() == [True, False, False, False][:bsz]
    elif kind not in ("integers", "signed_zeros"):
        assert bool(got[2].all())
    if kind == "signed_zeros":     # the -0 of the input reach the factor
        assert bool((torch.signbit(want[0]) & (want[0] == 0)).any())


@pytest.mark.parametrize("bsz, n, dtype, path", [
    (1, 4096, torch.float32, "blocked"),    # lu_inverse_refined's
    (64, 128, torch.float32, "cluster"),    # the small-n LU batch
    (1, 511, torch.float64, "cluster"),     # the cluster branch's largest
    (2, 512, torch.float64, "blocked"),
])
def test_l4_takes_the_planned_path(cuda, bsz, n, dtype, path):
    """Each eager getrf launches L4 once, on the path lu_factor_plan names
    for its shape: that path's counter grows by one, the other's not at
    all."""
    plan = lu.lu_factor_plan(bsz, n, torch.finfo(dtype).bits // 8)
    assert plan.path == path
    x = torch.eye(n, dtype=dtype, device=cuda).expand(bsz, n, n) * 2
    before = (lu._lu_factor_batched.launches,
              lu._lu_factor_batched.blocked_launches,
              lu._lu_factor_batched.cluster_launches)
    _, _, ok = lu._lu_factor_batched(x, pivot=True)
    assert bool(ok.all())
    grown = (lu._lu_factor_batched.launches - before[0],
             lu._lu_factor_batched.blocked_launches - before[1],
             lu._lu_factor_batched.cluster_launches - before[2])
    assert grown == ((1, 1, 0) if path == "blocked" else (1, 0, 1))


@pytest.mark.parametrize("bsz, n, k, dtype", [
    (1, 4096, 16, torch.float32),     # solve(..., refine_iters=2)
    (64, 128, 128, torch.float32),    # inverse(method="lu") on a batch
    (1, 200, 1, torch.float64),       # a vector right-hand side
    (2, 130, 33, torch.float64),      # ragged blocks and column tiles
    (4, 100, 5, torch.float64),       # singular, NaN and inf members
    (1, 4096, 4096, torch.float32),   # lu_inverse_refined's identity
    (1, 1000, 777, torch.float32),    # ragged, 13 tiles of a cluster of 16
    (3, 512, 300, torch.float32),     # a batch of three
    (1, 2048, 2048, torch.float64),   # fp64 at k = n
    (4, 600, 70, torch.float32),      # special members, a cluster of 16
    (1, 1001, 3, torch.float32),      # rows off 16 bytes: scalar loads
    (1, 12320, 2, torch.float32),     # past a cluster's shared memory
    (4, 200, 5, torch.float64),       # special members on a cluster
    (4, 130, 33, torch.float32),      # special members, ragged
])
def test_l5_matches_twin(cuda, bsz, n, k, dtype):
    """L5 (csrc/lu_solve.cu) against lu_solve_twin on the card: x's bits
    and ok identical, on factors from L4, on either path
    (``lu.lu_solve_plan``)."""
    rng = np.random.default_rng(n + k)
    kind = "special" if bsz == 4 else "normal"
    x = torch.from_numpy(_lu_members(rng, bsz, n, kind)).to(dtype).to(cuda)
    fac, perm, _ = lu._lu_factor_batched(x, pivot=True)
    rhs = torch.from_numpy(rng.standard_normal((bsz, n, k))).to(dtype).to(
        cuda)
    got = lu._lu_solve_batched(fac, perm, rhs)
    want = lu.lu_solve_twin(fac, perm, rhs)
    assert _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "special":
        # The infinite member's factor may hold its infinity as a pivot
        # with zero multipliers below it: x is then finite and ok true, in
        # the twin as in the kernel.
        assert got[1].tolist()[:3] == [True, False, False]
        assert bool(got[1][3]) == bool(torch.isfinite(got[0][3]).all())
    else:
        assert bool(got[1].all())


@pytest.mark.parametrize("bsz, n, k, dtype, path", [
    (1, 4096, 4096, torch.float32, "cluster"),
    (1, 4096, 16, torch.float32, "cluster"),
    (64, 128, 128, torch.float32, "cluster"),
    (1, 2048, 2048, torch.float64, "cluster"),
    (1, 12320, 2, torch.float32, "column"),
    (4, 128, 1, torch.float32, "column"),
])
def test_l5_takes_the_planned_path(cuda, bsz, n, k, dtype, path):
    """Each solve launches L5 once, on the path lu_solve_plan names for its
    shape: the path's own counter grows by one, the other's not at all."""
    plan = lu.lu_solve_plan(bsz, n, k, torch.finfo(dtype).bits // 8)
    assert ("cluster" if plan.cluster else "column") == path
    eye = torch.eye(n, k, dtype=dtype, device=cuda).expand(bsz, n, k)
    perm = torch.arange(n, device=cuda).expand(bsz, n).contiguous()
    fn = lu._lu_solve_batched
    before = (fn.launches, fn.cluster_launches, fn.column_launches)
    x, ok = fn(torch.eye(n, dtype=dtype, device=cuda).expand(bsz, n, n)
               .contiguous(), perm, eye.contiguous())
    torch.cuda.synchronize()
    grown = tuple(now - was for now, was in zip(
        (fn.launches, fn.cluster_launches, fn.column_launches), before))
    assert grown == ((1, 1, 0) if path == "cluster" else (1, 0, 1))
    assert bool(ok.all()) and torch.equal(x, eye)


@pytest.mark.parametrize("m, b, dtype, pivot, mask", [
    (4096, 128, torch.float64, True, "empty"),    # FP64 getrf 4096^2
    (4096, 128, torch.float64, True, "prior"),
    (1024, 128, torch.float64, True, "empty"),    # slogdet FP64 1024^2
    (1024, 128, torch.float64, False, "later"),   # no pivoting
    (520, 64, torch.float64, True, "prior"),
    (200, 64, torch.float64, True, "prior"),      # ragged
    (130, 32, torch.float32, True, "empty"),
    (16384, 256, torch.float64, True, "prior"),   # rows in a workspace
    (65600, 32, torch.float32, True, "empty"),
    (1024, 128, torch.float64, True, "inf"),
])
def test_l3_matches_twin(cuda, m, b, dtype, pivot, mask):
    """L3 (csrc/lu_panel.cu) against lu_panel_twin on the card: the
    panel's bits, pivot rows, mask and ok identical."""
    rng = np.random.default_rng(m + b)
    a = rng.standard_normal((m, b))
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    kb = 0
    if mask == "prior":
        used[torch.from_numpy(rng.permutation(m)[:m // 3]).to(cuda)] = 1
    elif mask == "later":
        a[:, :] += 4 * b * (np.arange(m)[:, None] == np.arange(b) + m // 2)
        used[:m // 2] = 1
        kb = m // 2
    elif mask == "inf":
        a[int(np.abs(a[:, 0]).argmax()), 5] = np.inf
    strip = torch.from_numpy(a).to(dtype).to(cuda)
    got = lu._lu_panel(strip, used, kb, b=b, pivot=pivot)
    want = lu.lu_panel_twin(strip, used, kb, b=b, pivot=pivot)
    assert _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool(got[3]) == bool(want[3])


def test_lu_routes_launch_the_loops(cuda):
    """On the card each LU route runs L3, L4 and L5 and never their plain
    loops: FP64 getri 1024^2 L3 once a panel (8); solve with 2 refinement
    steps at 1024^2 fp32 K3 and K5, then L5 once a step; a (16, 128^2)
    batch's getri L4 and L5 once each; slogdet on it L4 once;
    lu_inverse_refined at 256^2 L4 and L5 once each. Each meets its gate."""
    from gpu_matrix_inversion_tpu_torch import inverse, slogdet, solve
    from gpu_matrix_inversion_tpu_torch.ops.refine import lu_inverse_refined
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    a64 = torch.from_numpy(hollow_random_matrix(1024, seed=12,
                                                dtype=np.float64)).to(cuda)
    a32 = a64.float()
    batch = torch.from_numpy(np.stack([hollow_random_matrix(128, seed=s)
                                       for s in range(16)])).to(cuda)
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1024, 4)).astype(np.float32)).to(cuda)
    twins = (lu.lu_panel_twin, lu.lu_factor_twin, lu.lu_solve_twin)
    for t in twins:
        t.calls = 0
    cases = (
        (lambda: inverse(a64, method="lu"), {"L3": 8}),
        (lambda: solve(a32, rhs, method="lu", refine_iters=2),
         {"K3": 8, "K5": 8, "L5": 2}),
        (lambda: inverse(batch, method="lu"), {"L4": 1, "L5": 1}),
        (lambda: slogdet(batch), {"L4": 1}),
        (lambda: lu_inverse_refined(a64[:256, :256], iters=2,
                                    residual_dtype=torch.float64),
         {"L4": 1, "L5": 1}),
    )
    outs = []
    for call, want in cases:
        before = _counts()
        outs.append(call())
        torch.cuda.synchronize()
        assert _grown(before) == want
    assert all(t.calls == 0 for t in twins)
    inv64, ok = outs[0]
    assert bool(ok) and relative_residual(
        a64.cpu().numpy(), inv64.cpu().numpy()) < 1e-12
    x, ok = outs[1]
    berr = float(torch.linalg.norm(a32.double() @ x.double() - rhs.double())
                 / (torch.linalg.norm(a32.double())
                    * torch.linalg.norm(x.double())))
    assert bool(ok) and berr < 1e-5
    inv_b, ok = outs[2]
    assert bool(ok.all())
    sign, logabs, ok = outs[3]
    want_sign, want_log = np.linalg.slogdet(batch.double().cpu().numpy())
    assert bool(ok.all()) and np.array_equal(sign.cpu().numpy(), want_sign)
    assert np.allclose(logabs.cpu().numpy(), want_log, rtol=1e-4)
    inv_r, ok = outs[4]
    assert bool(ok) and relative_residual(
        a64[:256, :256].cpu().numpy(), inv_r.cpu().numpy()) < 1e-10


def test_lu_loops_take_bf16_in_fp32(cuda):
    """bf16 card tensors (ROADMAP Queue 3): L3, L4 and L5 compute in fp32
    and round their value outputs once to bf16, pivots, perm, mask and ok
    those of the fp32 run; the twins (the CPU's path) compute in bf16."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((2, 96, 96))).to(
        torch.bfloat16).to(cuda)
    got = lu._lu_factor_batched(x, pivot=True)
    want = lu._lu_factor_batched(x.float(), pivot=True)
    assert got[0].dtype == torch.bfloat16
    assert _same_bits(got[0], want[0].to(torch.bfloat16))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    rhs = torch.from_numpy(rng.standard_normal((2, 96, 3))).to(
        torch.bfloat16).to(cuda)
    x_b, ok_b = lu._lu_solve_batched(got[0], got[1], rhs)
    x_f, ok_f = lu._lu_solve_batched(got[0].float(), got[1], rhs.float())
    assert x_b.dtype == torch.bfloat16
    assert _same_bits(x_b, x_f.to(torch.bfloat16)) and torch.equal(ok_b, ok_f)
    strip = x[0, :, :32].contiguous()
    used = torch.zeros(96, dtype=torch.int32, device=cuda)
    p_b = lu._lu_panel(strip, used, 0, b=32, pivot=True)
    p_f = lu._lu_panel(strip.float(), used, 0, b=32, pivot=True)
    assert p_b[0].dtype == torch.bfloat16
    assert _same_bits(p_b[0], p_f[0].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(p_b[1:3], p_f[1:3]))
    assert bool(p_b[3]) == bool(p_f[3])


@pytest.mark.parametrize("lu_dtype, b_dtype", [
    (torch.float32, torch.float64), (torch.float64, torch.float32)])
def test_l5_takes_b_in_another_dtype(cuda, lu_dtype, b_dtype):
    """b in another dtype than the factor's (ROADMAP Queue 3): L5 solves in
    the wider of the two and returns x in b's dtype. Where b is the wider
    that is the twin's result bit for bit; where b is the narrower it is
    the wide solve rounded once (the twin rounds at every step), ok equal
    to the twin's."""
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.standard_normal((2, 96, 96))).to(cuda)
    fac, perm, _ = lu._lu_factor_batched(a, pivot=True)
    fac = fac.to(lu_dtype)
    b = torch.from_numpy(rng.standard_normal((2, 96, 5))).to(b_dtype).to(
        cuda)
    x, ok = lu._lu_solve_batched(fac, perm, b)
    wide = torch.promote_types(lu_dtype, b_dtype)
    x_wide, _ = lu._lu_solve_batched(fac.to(wide), perm, b.to(wide))
    want, want_ok = lu.lu_solve_twin(fac.cpu(), perm.cpu(), b.cpu())
    assert x.dtype == b_dtype and torch.equal(ok.cpu(), want_ok)
    assert _same_bits(x, x_wide.to(b_dtype))
    if b_dtype == wide:
        assert _same_bits(x.cpu(), want)


# The flat API's readback (``api._readback``): one copy from the card into
# a page-locked block of torch's host cache, which the answer's numpy view
# keeps alive and which a later call reuses once the caller drops it.

READBACK_SIZES = [512, 4096]


def _flat_input(n: int, seed: int) -> np.ndarray:
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    return hollow_random_matrix(n, seed=seed).reshape(-1)


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_flat_answer_lands_in_page_locked_memory(cuda, n):
    """The answer is a view of pinned memory, bit for bit the answer that
    ``inv.cpu()`` reads back, and counted as a pinned readback."""
    from gpu_matrix_inversion_tpu_torch import api
    from gpu_matrix_inversion_tpu_torch.models import solver
    flat = _flat_input(n, 101)
    inv, ok = solver.inverse(torch.from_numpy(flat.reshape(n, n)).to(cuda))
    assert bool(ok)
    want = inv.cpu().numpy().reshape(-1)
    api.clear_stats()
    out = api.matrix_inv_32(flat, n, device=cuda)
    assert api.stats() == {"pinned": 1, "pageable": 0}
    assert torch.from_numpy(out).is_pinned()
    assert out.shape == (n * n,) and out.dtype == np.float32
    assert out.flags.c_contiguous and out.flags.writeable
    assert out.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_held_flat_answers_share_no_memory(cuda, n):
    from gpu_matrix_inversion_tpu_torch import api
    flat = _flat_input(n, 102)
    first = api.matrix_inv_32(flat, n, device=cuda)
    second = api.matrix_inv_32(flat, n, device=cuda)
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first, flat)
    assert first.tobytes() == second.tobytes()


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_view_keeps_its_block_after_the_answer_is_dropped(cuda, n):
    """A reshaped view outlives the array it came from: five later calls
    on another input leave its values as they were, so no call reuses a
    block while a view of it lives."""
    from gpu_matrix_inversion_tpu_torch import api
    out = api.matrix_inv_32(_flat_input(n, 103), n, device=cuda)
    view = out.reshape(n, n)
    want = view.copy()
    del out
    other = _flat_input(n, 104)
    for _ in range(5):
        assert api.matrix_inv_32(other, n, device=cuda).size == n * n
    assert view.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_dropped_answers_return_their_blocks_to_the_cache(cuda, n):
    """Once an answer is dropped its block serves the next call: 20
    further calls make no new page-locked allocation."""
    from gpu_matrix_inversion_tpu_torch import api
    flat = _flat_input(n, 105)
    assert api.matrix_inv_32(flat, n, device=cuda).size == n * n
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    api.clear_stats()
    for _ in range(20):
        assert api.matrix_inv_32(flat, n, device=cuda).size == n * n
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    assert api.stats() == {"pinned": 20, "pageable": 0}


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_failed_pinned_allocation_reads_back_pageable(cuda, n, monkeypatch):
    """With page-locked allocation made to raise, as when host memory runs
    out, the call reads back into pageable memory: the same bits, counted
    as one pageable readback."""
    from gpu_matrix_inversion_tpu_torch import api
    flat = _flat_input(n, 106)
    want = api.matrix_inv_32(flat, n, device=cuda)
    empty = torch.empty

    def no_pinned(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinned)
    api.clear_stats()
    out = api.matrix_inv_32(flat, n, device=cuda)
    assert api.stats() == {"pinned": 0, "pageable": 1}
    assert not torch.from_numpy(out).is_pinned()
    assert out.shape == (n * n,) and out.flags.c_contiguous
    assert out.tobytes() == want.tobytes()
