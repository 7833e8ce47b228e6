"""Parity of the port's split blocked path (kernels K3 and K4 through their
plain twins), its FP64 tiers and the logical panel with the JAX package,
on the CPU.

Tolerances, each with its reason:
- K3 and the logical panel: pivot rows identical, ok equal. The inputs are
  standard_normal strips, whose pivots are well separated. The bf16 twin
  rounds every operation to bf16 (no contraction), which is what XLA's
  CPU backend does with the TPU kernel's bf16 code; fp32 rounds as K2.
- K4: bit-identical with ok equal (the twin rounds x - f*v once, as XLA's
  CPU code contracts it, and divides as IEEE does).
- Whole fp32 inverses: values within 1e-4 in max-abs relative difference
  (the port accumulates the driver's GEMMs, and the split path's C
  assembly, in float64 where the reference sums in fp32; Newton-Schulz
  sums in another order).
- Whole fp64 inverses: within 1e-10 (the reference's fp64 updates
  contract into FMAs, the port's round twice).
JAX calls stay at m <= 768 and b <= 64 except the FP64 tier's own b = 256
(interpret mode is slow).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gpu_matrix_inversion_tpu as jmi  # noqa: E402
import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu.ops import blocked as jblocked  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _jax_search(strip, used, dtype):
    """The JAX package's K3 in interpret mode on an (m, b) strip."""
    m, b = strip.shape
    with jax.enable_x64(False):
        p = jblocked._pivot_search(
            jnp.asarray(strip).astype(dtype), jnp.int32(0),
            jnp.asarray(used[:, None].astype(np.float32)), m=m, b=b,
            pivot=True, interpret=True)
    return np.asarray(p)


def _port_search(strip, used, dtype):
    st = torch.from_numpy(np.ascontiguousarray(strip.T)).to(dtype)
    return tblocked.pivot_search(st, torch.from_numpy(used)).numpy()


@pytest.mark.parametrize("mask", ["empty", "prior_panel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pivot_search_twin_matches_jax(dtype, mask):
    """K3 at m = 256, b = 64 (fp32: the reference's v2 body; bf16: its v1
    body), with an empty used mask and with a first panel's rows used."""
    m, b = 256, 64
    rng = np.random.default_rng(21)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    used = np.zeros(m, np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if mask == "prior_panel":
        used[_jax_search(rng.standard_normal((m, b)).astype(np.float32),
                         used, jdt)] = 1
    want = _jax_search(strip, used, jdt)
    got = _port_search(strip, used, tdt)
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, np.flatnonzero(used)).any()
    assert len(set(got.tolist())) == b


@pytest.mark.parametrize("data", ["integers", "near_ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pivot_search_twin_matches_jax_on_ties(dtype, data):
    """K3 where pivots tie: integer strips in [-3, 3] (exact ties in every
    column) and quarter-steps plus 1e-3 noise (near ties, which bf16
    rounding makes exact). The packed key's lowest-row rule and the
    per-op bf16 rounding pick the rows the JAX package picks."""
    m, b = 256, 64
    rng = np.random.default_rng(33)
    if data == "integers":
        strip = rng.integers(-3, 4, (m, b)).astype(np.float32)
    else:
        strip = (np.round(rng.standard_normal((m, b)) * 4) / 4
                 + rng.standard_normal((m, b)) * 1e-3).astype(np.float32)
    used = np.zeros(m, np.int32)
    want = _jax_search(strip, used, getattr(jnp, dtype))
    got = _port_search(strip, used, getattr(torch, dtype))
    np.testing.assert_array_equal(got, want)


def test_pivot_search_agrees_with_k2():
    """K3 in fp32 picks the pivots K2 picks (the same steps, without the
    C^T output), at m = 384 with sub-panels of 16."""
    m, b = 384, 48
    rng = np.random.default_rng(22)
    st = torch.from_numpy(rng.standard_normal((b, m)).astype(np.float32))
    used = torch.zeros(m, dtype=torch.int32)
    used[::7] = 1
    p2, _, ok = tblocked.panel_factor(st, 0, used, pivot=True)
    assert bool(ok)
    assert torch.equal(tblocked.pivot_search(st, used), p2)


@pytest.mark.parametrize("n", [4096, 8200, 16384, 16400, 32768, 40000,
                               65536])
def test_pivot_search_shared_memory_serves_the_gates(n):
    """Every (m, b, strip type) the gates hand K3 -- the split path's bf16
    strips up to m = 65536 at b = 32, fp32 strips up to m = 16384, the FP64
    tier's b = 256 at m = 4096 -- fits one CTA's shared memory at C = 16
    and at C = 8, with the working set in shared memory wherever it fits
    (so up to m ~ 55,000 in bf16 at C = 16)."""
    shapes = []
    for search_bf16 in (False, True):
        b, use_kernels, bf16 = tblocked._select_block_params(
            n, 256, torch.float32, search_bf16)
        assert use_kernels
        shapes.append((tblocked._round_up(n, b), b, 2 if bf16 else 4))
    shapes.append((4096, 256, 4))
    for m, b, elt in shapes:
        sub, _ = tblocked._factor_geometry(m, b)
        for cmax in (16, 8):
            geo = tblocked.cluster_geometry(m, b, sub, elt, cmax)
            assert geo.smem <= tblocked.SHARED_BYTES
            if cmax == 16:
                assert geo.wp_shared == (elt == 4 or m <= 55000)


# The shapes chip_smoke.py and the on-card tests give K2 (fp32) and K3.
GATE_SHAPES = [(256, 64, 4), (1024, 128, 4), (2048, 128, 4), (4096, 128, 4),
               (8192, 128, 4), (16384, 64, 4), (4096, 128, 2),
               (4096, 256, 4), (20032, 64, 2), (65536, 32, 2)]


@pytest.mark.parametrize("m,b,elt", GATE_SHAPES)
def test_cluster_geometry(m, b, elt):
    """K2's and K3's cluster: at most 16 (or 8) CTAs, each with at least
    128 lanes, the lanes covering m exactly once with no CTA empty; a CTA's
    shared memory within 232,448 bytes and at least 120 KiB (one CTA an
    SM), holding the working set where it fits and the strip rows only
    beside it; the bf16 (65536, 32) case, past m ~ 55,000, takes its
    working set from global memory at both sizes."""
    sub, _ = tblocked._factor_geometry(m, b)
    for cmax in (16, 8):
        geo = tblocked.cluster_geometry(m, b, sub, elt, cmax)
        assert 1 <= geo.cluster <= cmax
        assert geo.cluster == max(1, min(cmax, m // 128))
        starts = [r * geo.lanes for r in range(geo.cluster)]
        ends = [min(m, s + geo.lanes) for s in starts]
        assert all(e > s for s, e in zip(starts, ends))
        assert starts[0] == 0 and ends[-1] == m
        assert all(e == s for e, s in zip(ends, starts[1:]))
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
        assert 120 * 1024 <= geo.smem <= 232448 == tblocked.SHARED_BYTES
        assert geo.wp_shared or not geo.rows_shared
        if (m, b, elt) == (65536, 32, 2):
            assert not geo.wp_shared
    geo = tblocked.cluster_geometry(m, b, sub, elt)
    if (m, b) in ((4096, 128), (2048, 128)):
        assert geo.wp_shared and geo.rows_shared     # C^T slice in shared
    if (m, b, elt) == (20032, 64, 2):
        assert geo.wp_shared and not geo.rows_shared


def test_cluster_geometry_raises_past_one_cta():
    """Past ~3.6 million lanes at C = 16 even the used flags leave one
    CTA's shared memory: the wrapper raises rather than launch."""
    tblocked.cluster_geometry(3_500_000, 32, 16, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tblocked.cluster_geometry(3_700_000, 32, 16, 2)


def _jax_invert_small(d, pivot):
    with jax.enable_x64(False):
        inv, ok = jblocked._invert_small(jnp.asarray(d), pivot=pivot,
                                         interpret=True)
    return np.asarray(inv), bool(ok)


@pytest.mark.parametrize("b,pivot,case", [
    (32, True, "random"), (64, True, "random"), (32, False, "dominant"),
    (32, True, "singular"), (32, True, "integers"), (64, True, "integers"),
    (32, True, "quarters"), (32, False, "integers")])
def test_invert_small_twin_matches_jax(b, pivot, case):
    """K4's twin against ``_invert_small``: bit-identical, ok equal, on
    random blocks, a no-pivot diagonally dominant block, a singular block
    (a repeated row), and tie-heavy blocks that exercise the pivot rule's
    tie-break by row after the swaps: integers in [-3, 3] (exact ties in
    |column|) and quarter steps plus 1e-3 noise (near ties)."""
    rng = np.random.default_rng(b)
    d = rng.standard_normal((b, b)).astype(np.float32)
    if case == "integers":
        d = rng.integers(-3, 4, (b, b)).astype(np.float32)
    elif case == "quarters":
        d = (rng.integers(-8, 9, (b, b)) / 4
             + 1e-3 * rng.standard_normal((b, b))).astype(np.float32)
    if case == "dominant" or not pivot:
        d += b * np.eye(b, dtype=np.float32)
    elif case == "singular":
        d[5] = d[2]
        d[:, 7] = 0.0
    want, want_ok = _jax_invert_small(d, pivot)
    got, ok = tblocked.invert_small(torch.from_numpy(d), pivot=pivot)
    assert bool(ok) == want_ok == (case != "singular")
    if want_ok:
        np.testing.assert_array_equal(got.numpy(), want)


def test_invert_small_batched_and_nan():
    """A batch gives each block its single result; NaN input fails ok."""
    rng = np.random.default_rng(23)
    d = rng.standard_normal((3, 16, 16)).astype(np.float32)
    d[2, 4, 4] = np.nan
    inv, ok = tblocked.invert_small(torch.from_numpy(d), pivot=True)
    assert inv.shape == (3, 16, 16) and ok.tolist() == [True, True, False]
    one, ok1 = tblocked.invert_small(torch.from_numpy(d[1]), pivot=True)
    assert bool(ok1) and torch.equal(one, inv[1])


@pytest.mark.parametrize("refine", [0, 1])
def test_split_path_bf16_search_matches_jax(refine):
    """``search_bf16=True`` at n = 200 (b = 64, m = 256): K3 on bf16
    strips, K4, the C assembly. Raw with groups of two panels; refined
    through the public ``inverse`` with its default group."""
    rng = np.random.default_rng(24)
    a = rng.standard_normal((200, 200)).astype(np.float32)
    if refine == 0:
        kw = dict(block_size=64, group_size=2, refine=0, search_bf16=True)
        want, want_ok = jblocked.blocked_inverse(jnp.asarray(a), **kw)
        got, ok = tblocked.blocked_inverse(torch.from_numpy(a), **kw)
    else:
        kw = dict(method="blocked", block_size=64, search_bf16=True)
        want, want_ok = jmi.inverse(jnp.asarray(a), **kw)
        got, ok = tmi.inverse(torch.from_numpy(a), **kw)
    assert bool(ok) == bool(want_ok) and bool(ok)
    assert _rel(got, want) <= 1e-4
    assert relative_residual(a, got.numpy()) <= (1e-4 if refine == 0
                                                 else 1e-6)


def test_split_path_fp32_search_matches_jax(monkeypatch):
    """Past the fused-emit gate with an fp32 search (n > 16384 in real
    use; forced here at n = 136 in both packages): K3 in fp32 + K4."""
    assert not tblocked._emit_fused(16448, 64, True, False)
    monkeypatch.setattr(tblocked, "_emit_fused", lambda *args: False)
    monkeypatch.setattr(jblocked, "_emit_fused", lambda *args: False)
    rng = np.random.default_rng(25)
    a = rng.standard_normal((136, 136)).astype(np.float32)
    want, want_ok = jblocked.blocked_inverse(jnp.asarray(a), block_size=32,
                                             group_size=2, refine=0)
    got, ok = tblocked.blocked_inverse(torch.from_numpy(a), block_size=32,
                                       group_size=2, refine=0)
    assert bool(ok) == bool(want_ok) and bool(ok)
    assert _rel(got, want) <= 1e-4


def _panel_args(pkg, dtype, *, pivot, search_f32):
    if pkg == "jax":
        return dict(dtype=dtype, pivot=pivot, use_pallas=False,
                    interpret=True, search_bf16=False, emit=False,
                    search_f32=search_f32)
    return dict(pivot=pivot, use_kernels=False, search_bf16=False,
                emit=False, search_f32=search_f32, precision="highest")


@pytest.mark.parametrize("mask", ["empty", "prior_panel"])
def test_fp64_tier_panel_matches_jax(mask):
    """The FP64 f32-search tier on one (512, 64) panel: pivot rows
    identical, C^T within 1e-10, ok equal (the tier at its own b = 256
    runs in test_fp64_blocked_matches_jax)."""
    m, b = 512, 64
    rng = np.random.default_rng(26)
    strip = rng.standard_normal((m, b))
    used = np.zeros(m, np.int32)
    if mask == "prior_panel":
        used[rng.permutation(m)[:2 * b]] = 1
    jp, jct, jok = jblocked._factor_panel(
        jnp.asarray(strip), jnp.int32(0),
        jnp.asarray(used[:, None].astype(np.float32)), m=m, b=b,
        **_panel_args("jax", jnp.float64, pivot=True, search_f32=True))
    tp, tct, tok = tblocked._factor_panel(
        torch.from_numpy(strip), 0, torch.from_numpy(used), b=b,
        **_panel_args("torch", None, pivot=True, search_f32=True))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert bool(tok) == bool(jok) and bool(tok)
    assert _rel(tct.numpy(), jct) <= 1e-10


@pytest.mark.parametrize("case", ["pivot", "prior_panel", "no_pivot",
                                  "zero_column", "half_used", "ties",
                                  "no_pivot_prior", "fp32"])
def test_panel_pivots_logical_matches_jax(case):
    """The plain logical panel (L2's twin) against the JAX one on a
    (256, 32) strip, fp64 unless the case says fp32: pivot rows identical,
    ok equal (false on a column with no nonzero unused row). "ties" holds
    integers in [-3, 3], whose equal magnitudes go to the first row in
    both; "half_used" and "no_pivot_prior" start with half the rows used,
    as a later panel does."""
    m, b = 256, 32
    rng = np.random.default_rng(27)
    strip = rng.standard_normal((m, b))
    used = np.zeros(m, np.int32)
    kb, pivot = 0, case not in ("no_pivot", "no_pivot_prior")
    if case == "prior_panel":
        used[rng.permutation(m)[:64]] = 1
    elif case == "no_pivot":
        kb = 32
    elif case == "zero_column":
        used[:8] = 1
        strip[8:, 5] = 0.0
    elif case == "half_used":
        used[rng.permutation(m)[:m // 2]] = 1
    elif case == "ties":
        strip = rng.integers(-3, 4, (m, b)).astype(np.float64)
    elif case == "no_pivot_prior":
        used[:m // 2] = 1
        kb = m // 2
    elif case == "fp32":
        strip = strip.astype(np.float32)
    jp, _, jok = jblocked._panel_pivots_logical(
        jnp.asarray(strip), jnp.asarray(used[:, None].astype(np.float64)),
        jnp.int32(kb), m=m, b=b, pivot=pivot)
    tp, tok = tblocked._panel_pivots_logical(
        torch.from_numpy(strip), torch.from_numpy(used), kb, b=b,
        pivot=pivot)
    assert bool(tok) == bool(jok) == (case != "zero_column")
    if bool(jok):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_fp64_logical_route_matches_jax(monkeypatch):
    """Where the f32-search tier does not engage (in real use fp64 with
    b*m > 128*8192; here b = 36, not a multiple of 8, which closes the same
    gate at a CPU size) fp64 factors through the logical panel in both
    packages (n = 150, m = 180)."""
    rng = np.random.default_rng(28)
    a = rng.standard_normal((150, 150))
    calls = []
    real = tblocked._panel_pivots_logical
    monkeypatch.setattr(tblocked, "_panel_pivots_logical",
                        lambda *args, **kw: calls.append(1) or real(*args,
                                                                    **kw))
    got, ok = tblocked.blocked_inverse(torch.from_numpy(a), block_size=36,
                                       refine=0)
    want, want_ok = jblocked.blocked_inverse(jnp.asarray(a), block_size=36,
                                             refine=0)
    assert len(calls) == 5 and bool(ok) and bool(want_ok)
    assert _rel(got, want) <= 1e-10


def test_fp64_blocked_matches_jax():
    """FP64 at n = 600: b = 256, m = 768, the f32-search tier (K3's twin)
    with the pivot block inverted in fp64, and the default polish."""
    a = hollow_random_matrix(600, seed=29, dtype=np.float64)
    want, want_ok = jblocked.blocked_inverse(jnp.asarray(a))
    got, ok = tblocked.blocked_inverse(torch.from_numpy(a))
    assert got.dtype == torch.float64
    assert bool(ok) == bool(want_ok) and bool(ok)
    assert _rel(got, want) <= 1e-10
    assert relative_residual(a, got.numpy()) < 1e-13


def test_fp64_api_and_no_pivots_match_jax():
    """``matrix_inversion_fp64`` at n = 600 and ``matrix_inversion_no_pivots``
    on a diagonally dominant n = 600 input (the logical panel, no pivots)
    against the JAX package; no-pivots on a zero-diagonal input returns
    empty, the pivoted FP64 call inverts it (verify flow 5)."""
    n = 600
    a = hollow_random_matrix(n, seed=30, dtype=np.float64)
    got = tmi.matrix_inversion_fp64(a.reshape(-1), n, device="cpu")
    want = jmi.matrix_inversion_fp64(a.reshape(-1), n)
    assert _rel(got, want) <= 1e-10
    assert relative_residual(a, got.reshape(n, n)) < 1e-13
    assert tmi.matrix_inversion_no_pivots(a.reshape(-1), n,
                                          device="cpu").size == 0
    assert jmi.matrix_inversion_no_pivots(a.reshape(-1), n).size == 0
    dom = a + 2.0 * np.abs(a).sum(axis=1).max() * np.eye(n)
    got = tmi.matrix_inversion_no_pivots(dom.reshape(-1), n, device="cpu")
    want = jmi.matrix_inversion_no_pivots(dom.reshape(-1), n)
    assert got.size == n * n
    assert _rel(got, want) <= 1e-10
    assert relative_residual(dom, got.reshape(n, n)) < 1e-13


def test_fp64_bench_and_batch():
    """``fp64_bench`` at n = 520 returns its Res; an fp64 batch past the
    fused route loops one matrix at a time."""
    n = 520
    a = hollow_random_matrix(n, seed=31, dtype=np.float64)
    res = tmi.fp64_bench(a.reshape(-1), n, device="cpu")
    assert res.ok and res.inversa64.size == n * n
    assert relative_residual(a, res.inversa64.reshape(n, n)) < 1e-13
    batch = np.stack([a, hollow_random_matrix(n, seed=32,
                                              dtype=np.float64)])
    inv, ok = tmi.inverse(torch.from_numpy(batch), block_size=128)
    assert inv.shape == batch.shape and ok.tolist() == [True, True]
    assert relative_residual(batch[1], inv[1].numpy()) < 1e-13
