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

Tolerances as in ``chip_smoke.py``: pivot sequences identical, ok equal,
values within 1e-4 of max|twin|; K1, K4 and K5 also elementwise against
the twin (``_hold_to_twin``), K1's cluster branch byte-identical across
cluster sizes; K2 bit for bit against its twin on the CPU, K6 against K2
per matrix and that twin; K7 as its test states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpu_matrix_inversion_tpu_torch.ops import blocked, fused, lu  # noqa: E402,E501

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
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bsz,m,pivot,dtype,kind", [
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
])
def test_k1_matches_twin(cuda, bsz, m, pivot, dtype, kind):
    """K1 against its twin on the card (pos identical, ok equal, 1e-4) and
    elementwise against the twin on the CPU, on random and tie-heavy
    inputs (the packed key's tie-break by row)."""
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
                                    (4096, 128, 0)])
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


@pytest.mark.parametrize("b", [128, 64, 40, 8])
def test_k5_matches_twin(cuda, b):
    """K5 at getrf's b = 128 and at smaller blocks that leave warps, rows
    and columns of its register layout empty."""
    rng = np.random.default_rng(5 + b)
    d = rng.standard_normal((3, b, b)).astype(np.float32)
    d += b * np.eye(b, dtype=np.float32)
    d[2, 7, :8] = 0.0                      # a zero pivot
    x = torch.from_numpy(d).to(cuda)
    lu_k, ok_k = lu.small_lu(x)
    lu_t, ok_t = lu.small_lu_twin(x)
    assert ok_k.tolist() == ok_t.tolist() == [True, True, False]
    assert _rel(lu_k[:2], lu_t[:2]) <= 1e-4
    # Elementwise, as chip_smoke.py phase 4c: the twin on the CPU takes the
    # same operations in the same order, and parts from K5 only where its
    # float64 emulation of fmaf rounds twice; one skipped update or a
    # multiplier off by a percent breaks this bound, and a division or an
    # update that rounds otherwise parts in the bits of far more than one
    # element in a thousand.
    got, want = lu_k[:2].cpu(), lu.small_lu_twin(x[:2].cpu())[0]
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


def test_ns_and_inverter(cuda):
    """inverse(method="ns") and Inverter on the card: the JAX package's
    gates (residual <= 1e-5, ok false on a singular input)."""
    from gpu_matrix_inversion_tpu_torch import Inverter, inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    w = well_conditioned_matrix(512, seed=92)
    x, ok = inverse(torch.from_numpy(w).to(cuda), method="ns")
    assert bool(ok) and relative_residual(w, x.cpu().numpy()) < 1e-5
    _, ok = inverse(torch.ones(256, 256, device=cuda), method="ns")
    assert not bool(ok)
    h = hollow_random_matrix(1024, seed=93)
    for method in ("blocked", "ns"):
        src = w if method == "ns" else h
        x, ok = Inverter(method=method, refine_iters=1).inverse(src)
        assert x.device.type == "cuda"
        assert bool(ok) and relative_residual(src, x.cpu().numpy()) < 1e-5


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


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def test_potri_on_card(cuda):
    """potri at 1024^2 under the residual gate chip_smoke.py holds at
    4096^2 (1e-6), bit-identical through inverse(method="cholesky"); one
    diagonal entry set to -50 gives ok False, no exception."""
    from gpu_matrix_inversion_tpu_torch import cholesky_inverse, inverse
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    a = _spd(1024, seed=1024)
    x = torch.from_numpy(a).to(cuda)
    inv, ok = cholesky_inverse(x)
    assert bool(ok) and relative_residual(a, inv.cpu().numpy()) <= 1e-6
    inv2, ok2 = inverse(x, method="cholesky")
    assert bool(ok2) and torch.equal(inv, inv2)
    bad = x.clone()
    bad[517, 517] = -50.0
    _, ok_bad = cholesky_inverse(bad)
    assert not bool(ok_bad)


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
    x = torch.from_numpy(_spd(256, seed=3)).to(cuda)
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
    x = torch.from_numpy(_spd(512, seed=5)).to(cuda)
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


def test_sharded_dp_only_batch_equals_fused(cuda, nccl_world):
    """A (1, 1) (dp, tp) cuda mesh with n <= 640 runs K1 on the local
    batch: bit for bit ``fused_inverse``; a singular member's ok alone
    false."""
    from gpu_matrix_inversion_tpu_torch.parallel import (
        make_device_mesh, sharded_batched_inverse)
    mesh = make_device_mesh((1, 1), ("dp", "tp"))
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((64, 128, 128)).astype(
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
    """Each compiled route at a small shape: (name, function name in
    graphs.stats(), call)."""
    from gpu_matrix_inversion_tpu_torch import (cholesky_inverse, inverse,
                                                solve)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
    rng = np.random.default_rng(11)
    h = torch.from_numpy(hollow_random_matrix(1024, seed=5)).to(cuda)
    h64 = torch.from_numpy(hollow_random_matrix(512, seed=6,
                                                dtype=np.float64)).to(cuda)
    dom = h64 + 2 * h64.abs().sum(dim=1).max() * torch.eye(
        512, dtype=torch.float64, device=cuda)
    small64 = torch.from_numpy(hollow_random_matrix(
        128, seed=7, dtype=np.float64)).to(cuda)
    batch = torch.from_numpy(np.stack([
        hollow_random_matrix(1024, seed=20 + i) for i in range(3)])).to(cuda)
    spd = torch.from_numpy(_spd(512, seed=8)).to(cuda)
    wc = torch.from_numpy(well_conditioned_matrix(512, seed=9)).to(cuda)
    rhs = torch.from_numpy(rng.standard_normal((1024, 4)).astype(
        np.float32)).to(cuda)
    small = torch.from_numpy(np.stack([
        hollow_random_matrix(128, seed=30 + i) for i in range(16)])).to(cuda)
    small_rhs = torch.from_numpy(rng.standard_normal((16, 128, 3)).astype(
        np.float32)).to(cuda)
    lu_s, perm_s, _ = lu._lu_factor_batched(small, pivot=True)
    return {
        "blocked": ("blocked_inverse", lambda: inverse(h)),
        "bf16 search": ("blocked_inverse",
                        lambda: inverse(h, search_bf16=True)),
        "FP64 tier": ("blocked_inverse", lambda: inverse(h64)),
        "no-pivot FP64": ("blocked_inverse",
                          lambda: inverse(dom, pivot=False)),
        "per-matrix batch": ("blocked_inverse", lambda: inverse(batch)),
        "LU getri": ("lu_inverse_fast", lambda: inverse(h, method="lu")),
        "LU solve": ("lu_solve_fast", lambda: solve(h, rhs)),
        "potri": ("cholesky_inverse", lambda: cholesky_inverse(spd)),
        "Cholesky solve": ("cholesky_solve",
                           lambda: solve(spd, rhs[:512], method="cholesky")),
        "Newton-Schulz": ("newton_schulz_inverse",
                          lambda: inverse(wc, method="ns")),
        "spec": ("gauss_jordan_inverse", lambda: inverse(small64)),
        "LU spec getrf": ("lu_factor", lambda: lu.lu_factor(small)),
        "LU spec getrs": ("lu_solve",
                          lambda: lu.lu_solve(lu_s, perm_s, small_rhs)),
        "LU spec getri": ("lu_inverse", lambda: lu.lu_inverse(small)),
        "LU spec solve": ("lu_solve_matrix",
                          lambda: lu.lu_solve_matrix(small, small_rhs)),
        "slogdet FP64 (L3 panels)": ("slogdet", lambda: lu.slogdet(h64)),
    }


def _leaves(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _assert_bits(got, want) -> None:
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("route", [
    "blocked", "bf16 search", "FP64 tier", "no-pivot FP64",
    "per-matrix batch", "LU getri", "LU solve", "potri", "Cholesky solve",
    "Newton-Schulz", "spec", "LU spec getrf", "LU spec getrs",
    "LU spec getri", "LU spec solve", "slogdet FP64 (L3 panels)"])
def test_replay_equals_eager(graph_cache, cuda, route):
    """Eager (graphs.disabled()), the first call (the capture) and a
    replay give the same bits, outputs and ok; stats() shows one capture,
    then replays; a replay runs no kernel wrapper; the graphs hold the
    port's kernels as the wrappers counted them eagerly, and the
    profiler's records show none more often, eager or replayed."""
    graphs = graph_cache
    fn_name, call = _route_calls(cuda)[route]
    with graphs.disabled():
        call()                          # builds the kernels, fills caches
        before = _counts()
        eager = call()
        eager_counts = _as_records(_grown(before))
        assert _at_most(_records(call), eager_counts)
    assert graphs.stats() == {}
    first = call()
    assert graphs.stats()[fn_name] == {"captures": 1, "replays": 1}
    before = _counts()
    replayed = call()
    assert _grown(before) == {}
    assert graphs.stats()[fn_name] == {"captures": 1, "replays": 2}
    assert _nodes(graphs.cached()) == eager_counts
    assert _at_most(_records(call), eager_counts)
    assert _grown(before) == {}
    _assert_bits(first, eager)
    _assert_bits(replayed, eager)


def test_lockstep_replay_equals_eager(graph_cache, cuda, monkeypatch):
    """The lockstep route (MATINV_LOCKSTEP=1, K6) replayed bit for bit as
    it runs eagerly, its graph holding K6's eager launches; the
    environment variable is part of the key, so the per-matrix graph is
    another."""
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    graphs = graph_cache
    x = torch.from_numpy(np.stack([hollow_random_matrix(1024, seed=40 + i)
                                   for i in range(4)])).to(cuda)
    per_matrix = inverse(x)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    with graphs.disabled():
        before = _counts()
        eager = inverse(x)
        eager_counts = _grown(before)
    assert eager_counts.get("K6") == 8
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


@pytest.mark.parametrize("bsz, n, dtype, pivot, kind", [
    (1, 256, torch.float64, True, "normal"),      # the FP64 tier's block
    (64, 256, torch.float64, True, "normal"),
    (1, 511, torch.float64, True, "normal"),      # cluster of 16
    (4, 100, torch.float32, False, "normal"),
    (4, 256, torch.float64, True, "integers"),    # exact ties
    (1, 640, torch.float32, True, "normal"),      # the grid branch
    (2, 1000, torch.float64, False, "normal"),
])
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


@pytest.mark.parametrize("n", [256, 640])
def test_l1_ok_on_singular_and_nan_blocks(cuda, n):
    """A regular, a singular (a zero row) and a NaN block: ok as the
    twin's, true, false, false."""
    from gpu_matrix_inversion_tpu_torch.ops import gauss_jordan
    a = np.random.default_rng(n).standard_normal((3, n, n))
    a[1, 3] = 0.0
    a[2, 7, 9] = np.nan
    x = torch.from_numpy(a).to(cuda)
    ok = gauss_jordan._gauss_jordan_aug(x, pivot=True)[1]
    assert ok.tolist() == [True, False, False]
    assert torch.equal(ok, gauss_jordan.gauss_jordan_twin(x, pivot=True)[1])


@pytest.mark.parametrize("m, b, dtype, pivot, mask", [
    (512, 64, torch.float64, True, "half"),
    (4096, 256, torch.float64, False, "half"),    # a later no-pivot panel
    (8192, 256, torch.float64, True, "empty"),
    (16384, 256, torch.float64, True, "half"),    # rows in a workspace
    (65600, 32, torch.float32, True, "empty"),
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
    elif mask == "half":
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
    ties); special: a regular member, a singular one (a zero row), one
    holding a NaN and one holding an infinity."""
    if kind == "integers":
        return rng.integers(-3, 4, (bsz, n, n)).astype(np.float64)
    a = rng.standard_normal((bsz, n, n))
    if kind == "dominant":
        a += n * np.eye(n)
    if kind == "special":
        a[1, 3] = 0.0
        a[2, n // 2, n // 3] = np.nan
        a[3, n // 3, n // 2] = np.inf
    return a


@pytest.mark.parametrize("bsz, n, dtype, pivot, kind", [
    (64, 128, torch.float32, True, "normal"),     # the small-n LU batch
    (1, 200, torch.float64, True, "normal"),
    (1, 130, torch.float32, False, "dominant"),
    (4, 256, torch.float64, True, "integers"),    # exact ties
    (4, 100, torch.float64, True, "special"),
    (1, 640, torch.float32, True, "normal"),      # the grid branch
    (4, 600, torch.float64, True, "special"),
    (1, 2000, torch.float64, False, "dominant"),  # rows in a workspace
])
def test_l4_matches_twin(cuda, bsz, n, dtype, pivot, kind):
    """L4 (csrc/gauss_jordan.cu, LU mode) against lu_factor_twin on the
    card: the factor's bits, perm and ok identical."""
    a = _lu_members(np.random.default_rng(n + bsz), bsz, n, kind)
    x = torch.from_numpy(a).to(dtype).to(cuda)
    got = lu._lu_factor_batched(x, pivot=pivot)
    want = lu.lu_factor_twin(x, pivot=pivot)
    assert _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if kind == "special":
        assert got[2].tolist() == [True, False, False, False]


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
        assert got[1].tolist() == [True, False, False, False]


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
    (1024, 128, torch.float64, False, "later"),   # no pivoting
    (520, 64, torch.float64, True, "prior"),
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
