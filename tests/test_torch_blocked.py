"""Parity of the port's blocked route (kernel K2's plain twin, the blocked
driver, Newton-Schulz) with the JAX package, on the CPU.

Tolerances: pivot rows identical, ok flags equal, values within 1e-4 in
max-abs relative difference on standard_normal inputs. Measured gaps on
these inputs: K2 0.0 (the twin rounds as XLA's CPU code does);
blocked_inverse at precision="highest" raw 2.9e-5 and refined 5.2e-6 (the
port accumulates the driver's GEMMs in float64 where the reference sums in
fp32); at precision="high", where both drivers run FP32 GEMMs on the CPU,
raw 0.0 (bit-identical) and refined 4.2e-6 (the Newton-Schulz GEMMs sum in
another order). JAX calls stay at m <= 256 (interpret mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gpu_matrix_inversion_tpu.ops import blocked as jblocked  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501

TOL = 1e-4


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _jax_panel(strip, kb, used, *, pivot):
    m, b = strip.shape
    p, ct, ok = jblocked._panel_factor(
        jnp.asarray(strip), jnp.int32(kb),
        jnp.asarray(used[:, None].astype(np.float32)), m=m, b=b, pivot=pivot,
        interpret=True)
    return np.asarray(p), np.asarray(ct), bool(ok)


def _port_panel(strip, kb, used, *, pivot):
    p, ct, ok = tblocked.panel_factor(
        torch.from_numpy(np.ascontiguousarray(strip.T)), kb,
        torch.from_numpy(used), pivot=pivot)
    return p.numpy(), ct.numpy(), bool(ok)


@pytest.mark.parametrize("case", ["empty_mask", "prior_panel", "no_pivot"])
def test_panel_twin_matches_jax(case):
    """K2 at m = 256, b = 64: an empty used mask; the same strip as a later
    panel with the first panel's rows consumed (the pattern of
    test_blocked.py:120-149); and pivot=False at kb = 64."""
    m, b = 256, 64
    rng = np.random.default_rng(11)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    used = np.zeros(m, np.int32)
    kb, pivot = 0, True
    if case == "prior_panel":
        first, _, _ = _jax_panel(strip, 0, used, pivot=True)
        used[first] = 1
        kb = b
    elif case == "no_pivot":
        kb, pivot = b, False
    j_p, j_ct, j_ok = _jax_panel(strip, kb, used, pivot=pivot)
    t_p, t_ct, t_ok = _port_panel(strip, kb, used, pivot=pivot)
    np.testing.assert_array_equal(t_p, j_p)
    assert t_ok == j_ok
    assert t_ok
    assert t_ct.shape == (b, m)
    assert _rel(t_ct, j_ct) <= TOL
    if case == "prior_panel":
        assert not np.isin(t_p, np.flatnonzero(used)).any()


def test_panel_twin_applies_the_panel():
    """X + C @ X[pivrows] eliminates the panel: pivot rows become D^-1 D
    = I, every other row of the strip 0 (test_pivot_oracle.py's check)."""
    m, b = 128, 32
    rng = np.random.default_rng(12)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    used = np.zeros(m, np.int32)
    used[:8] = 1
    p, ct, ok = _port_panel(strip, 0, used, pivot=True)
    assert ok and not np.isin(p, np.arange(8)).any()
    x = strip.astype(np.float64)
    x_new = x + ct.T.astype(np.float64) @ x[p]
    np.testing.assert_allclose(x_new[p], np.eye(b), atol=1e-4)
    rest = np.ones(m, bool)
    rest[p] = False
    np.testing.assert_allclose(x_new[rest], 0.0, atol=1e-4)


def test_panel_flags_zero_pivot():
    """Unused rows all zero in one column: ok is False in both packages."""
    m, b = 256, 16
    rng = np.random.default_rng(5)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    strip[8:, 3] = 0.0
    used = np.zeros(m, np.int32)
    used[:8] = 1
    assert not _jax_panel(strip, 0, used, pivot=True)[2]
    assert not _port_panel(strip, 0, used, pivot=True)[2]


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("refine", [0, 1])
def test_blocked_inverse_matches_jax(refine, precision):
    """n = 200, block_size = 64, group_size = 2: padding to m = 256, two
    groups of two panels, and the two final gathers. ``"high"`` on the CPU
    runs the driver's GEMMs in plain FP32 in both packages (TF32 and the
    TPU's bf16 passes do not exist there), so it holds the port's FP32
    driver to the reference's."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal((200, 200)).astype(np.float32)
    j_inv, j_ok = jblocked.blocked_inverse(jnp.asarray(a), block_size=64,
                                           group_size=2, refine=refine,
                                           precision=precision)
    t_inv, t_ok = tblocked.blocked_inverse(torch.from_numpy(a),
                                           block_size=64, group_size=2,
                                           refine=refine,
                                           precision=precision)
    assert bool(t_ok) == bool(j_ok) and bool(t_ok)
    assert t_inv.shape == (200, 200)
    assert _rel(t_inv, j_inv) <= TOL


@pytest.mark.parametrize("refine", [0, 1])
def test_blocked_hollow_residual(refine):
    """The hollow protocol input with a tail group (n = 300, b = 64:
    5 panels, groups of 2 + a tail of 1), port only: residual gates raw
    <= 1e-4 and refined <= 1e-6."""
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    a = hollow_random_matrix(300, seed=3)
    inv, ok = tblocked.blocked_inverse(torch.from_numpy(a), block_size=64,
                                       group_size=2, refine=refine)
    assert bool(ok)
    res = relative_residual(a, inv.numpy())
    assert res <= (1e-4 if refine == 0 else 1e-6)


def test_blocked_batched_and_bf16():
    """A batch loops one matrix at a time (each equals its single call);
    bf16 input computes in fp32 and returns bf16."""
    rng = np.random.default_rng(14)
    a = rng.standard_normal((2, 96, 96)).astype(np.float32)
    inv, ok = tblocked.blocked_inverse(torch.from_numpy(a), block_size=32)
    assert inv.shape == (2, 96, 96) and bool(ok.all())
    one, _ = tblocked.blocked_inverse(torch.from_numpy(a[1]), block_size=32)
    np.testing.assert_array_equal(inv[1].numpy(), one.numpy())
    inv16, ok16 = tblocked.blocked_inverse(
        torch.from_numpy(a[0]).to(torch.bfloat16), block_size=32)
    assert inv16.dtype == torch.bfloat16 and bool(ok16)


@pytest.mark.parametrize("n", [1, 7, 64, 100, 200, 511, 512, 1000, 1950,
                               4096, 6000, 8192, 8200, 10000, 16384, 16400,
                               40000, 70000])
def test_geometry_matches_jax(n):
    """The copied geometry functions pick what the JAX package picks."""
    for bs in (32, 64, 128, 256):
        for bf16 in (False, True):
            j = jblocked._select_block_params(n, bs, jnp.float32, bf16)
            t = tblocked._select_block_params(n, bs, torch.float32, bf16)
            assert t == j
            b = t[0]
            m = max(tblocked._round_up(n, b), b)
            assert (tblocked._factor_geometry(m, b)
                    == jblocked._factor_geometry(m, b))
            assert (tblocked._emit_fused(m, b, t[1], t[2])
                    == jblocked._emit_fused(m, b, j[1], j[2]))
            assert (tblocked._default_group_size(b, m // b)
                    == jblocked._default_group_size(b, m // b))
            assert (tblocked._default_group_size(b)
                    == jblocked._default_group_size(b))
        assert (tblocked.effective_gemm_flops(n, block_size=bs)
                == jblocked.effective_gemm_flops(n, block_size=bs))
    assert (tblocked._select_block_params(n, 256, torch.float64, False)
            == jblocked._select_block_params(n, 256, jnp.float64, False))

