"""Parity of the port's fused route (kernel K1's plain twin) with the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernel in interpret mode and through the port. Tolerances: pivot
positions identical, ok flags equal, values within 1e-4 in max-abs
relative difference (max|X_port - X_jax| / max|X_jax|). Measured gap on
these inputs: 0.0 -- the twin rounds as XLA's CPU code does (one FMA per
elimination update, IEEE division), so the outputs are bit-identical;
the 1e-4 bound leaves room for a different XLA or torch build.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gpu_matrix_inversion_tpu.ops import fused as jfused  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import fused as tfused  # noqa: E402

TOL = 1e-4


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _inputs(n: int, pivot: bool, batch: int = 3, seed: int = 0):
    """standard_normal (B, n, n); the no-pivot variant adds n*I, since
    elimination without pivoting assumes a usable diagonal."""
    rng = np.random.default_rng(1000 * n + seed)
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    if not pivot:
        a += n * np.eye(n, dtype=np.float32)
    return a


def _pad(a: np.ndarray) -> np.ndarray:
    """blockdiag(A, I) at m = round_up(n, 128), as _fused_batched pads."""
    bsz, n, _ = a.shape
    m = max(tfused._round_up(n, 128), 128)
    out = np.broadcast_to(np.eye(m, dtype=a.dtype), (bsz, m, m)).copy()
    out[:, :n, :n] = a
    return out


def _jax_gj_kernel(a: np.ndarray, *, pivot: bool):
    """The JAX package's K1 body through the pallas_call of
    fused.py:285-306 (pack = 1, interpret mode); returns the raw
    pivot-order inverse, pos (B, m) and ok (B,)."""
    bsz, m, _ = a.shape
    kernel = functools.partial(jfused._gj_kernel, m=m, pivot=pivot, pack=1)

    def spec(shape):
        return pl.BlockSpec(shape, lambda i: (i, 0, 0),
                            memory_space=pltpu.VMEM)

    with jax.enable_x64(False):
        inv, pos, ok = pl.pallas_call(
            kernel,
            grid=(bsz,),
            in_specs=[spec((1, m, m))],
            out_specs=(spec((1, m, m)), spec((1, m, 1)), spec((1, 1, 1))),
            out_shape=(jax.ShapeDtypeStruct((bsz, m, m), a.dtype),
                       jax.ShapeDtypeStruct((bsz, m, 1), jnp.int32),
                       jax.ShapeDtypeStruct((bsz, 1, 1), jnp.int32)),
            scratch_shapes=[pltpu.VMEM((1, m, 2 * m), jnp.float32)],
            interpret=True,
        )(jnp.asarray(a))
    return (np.asarray(inv.astype(jnp.float32)), np.asarray(pos)[:, :, 0],
            np.asarray(ok)[:, 0, 0] > 0)


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("n", [5, 128, 200])
def test_gj_twin_matches_jax_kernel(n, pivot):
    """Raw kernel outputs: pos identical, ok equal, pivot-order inverse
    within tolerance."""
    a = _pad(_inputs(n, pivot))
    j_inv, j_pos, j_ok = _jax_gj_kernel(a, pivot=pivot)
    t_inv, t_pos, t_ok = tfused.gj_kernel(torch.from_numpy(a), pivot=pivot)
    np.testing.assert_array_equal(t_pos.numpy(), j_pos)
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    assert j_ok.all()
    assert _rel(t_inv, j_inv) <= TOL


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("n", [5, 128, 200])
def test_fused_inverse_matches_jax(n, pivot):
    a = _inputs(n, pivot, seed=1)
    j_inv, j_ok = jfused.fused_inverse(jnp.asarray(a), pivot=pivot)
    t_inv, t_ok = tfused.fused_inverse(torch.from_numpy(a), pivot=pivot)
    assert t_inv.shape == (3, n, n) and t_inv.dtype == torch.float32
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert _rel(t_inv, j_inv) <= TOL


def test_fused_bf16_matches_jax():
    """bf16 is an I/O format: fp32 compute, bf16 out. The same fp32 values
    round to the same bf16 values, so the tolerance is the fp32 one."""
    a = jnp.asarray(_inputs(128, True, seed=2)).astype(jnp.bfloat16)
    a_t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)
    j_inv, j_ok = jfused.fused_inverse(a)
    t_inv, t_ok = tfused.fused_inverse(a_t)
    assert t_inv.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert _rel(t_inv.float(), j_inv.astype(jnp.float32)) <= TOL
    # pos and ok of the raw kernels on the bf16 input.
    padded = np.asarray(a)
    _, j_pos, j_kok = _jax_gj_kernel(padded, pivot=True)
    _, t_pos, t_kok = tfused.gj_kernel(a_t.contiguous(), pivot=True)
    np.testing.assert_array_equal(t_pos.numpy(), j_pos)
    np.testing.assert_array_equal(t_kok.numpy(), j_kok)


def test_fused_flags_singular_and_nan():
    """A singular and a NaN batch item flag ok=False in both packages; the
    well-posed item beside them stays ok."""
    n = 48
    a = _inputs(n, True, seed=3)
    a[1] = 1.0                       # rank 1
    a[2, 5, 7] = np.nan
    j_inv, j_ok = jfused.fused_inverse(jnp.asarray(a))
    t_inv, t_ok = tfused.fused_inverse(torch.from_numpy(a))
    np.testing.assert_array_equal(t_ok.numpy(), [True, False, False])
    np.testing.assert_array_equal(np.asarray(j_ok), [True, False, False])
    assert _rel(t_inv[0], np.asarray(j_inv)[0]) <= TOL


def test_fused_hollow_residual_and_padding():
    """The reference's hollow protocol input (zero diagonal forces a pivot
    every step) at a non-multiple of 128: residual gate, un-padded shape,
    and a batched call equals the single calls."""
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    a = np.stack([hollow_random_matrix(100, seed=s) for s in range(2)])
    inv, ok = tfused.fused_inverse(torch.from_numpy(a))
    assert inv.shape == (2, 100, 100) and bool(ok.all())
    for s in range(2):
        assert relative_residual(a[s], inv[s].numpy()) < 1e-5
        one, _ = tfused.fused_inverse(torch.from_numpy(a[s]))
        np.testing.assert_array_equal(one.numpy(), inv[s].numpy())


def test_fused_rejects_what_it_does_not_serve():
    with pytest.raises(NotImplementedError):
        tfused.fused_inverse(torch.zeros((4, 4), dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        tfused.fused_inverse(torch.zeros((641, 641)))
    with pytest.raises(ValueError):
        tfused.gj_kernel(torch.zeros((1, 100, 100)), pivot=True)
