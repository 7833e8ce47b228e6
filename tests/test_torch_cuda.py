"""On-card checks of the port's CUDA kernels against their plain twins.

Marked ``gpu``: they need an NVIDIA Hopper GPU and ``nvcc``, and skip
without a CUDA device (decided inside the ``cuda`` fixture, so every
pytest worker collects the same tests). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have.)

Tolerances as in ``chip_smoke.py``: pivot sequences identical, ok equal,
values within 1e-4 of max|twin|; K1, K4 and K5 also elementwise against
the twin (``_hold_to_twin``); K6 bit for bit against K2 and its twin on
the CPU; K7 as its test states.
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
    (2, 256, True, torch.float32, "normal"),     # global-workspace branch
    (1, 640, True, torch.float32, "normal"),
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
    batch = np.stack([hollow_random_matrix(1024, seed=30 + i)
                      for i in range(5)])
    batch[3] = 1.0
    x = torch.from_numpy(batch).to(cuda)
    off, ok_off = inverse(x)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    k2, k6 = blocked.panel_factor.launches, lockstep.lockstep_factor.launches
    on, ok_on = inverse(x)
    assert blocked.panel_factor.launches == k2
    assert lockstep.lockstep_factor.launches == k6 + 8
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
