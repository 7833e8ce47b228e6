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
@pytest.mark.parametrize("n,kind", [
    pytest.param(5, "normal", id="5"), pytest.param(128, "normal", id="128"),
    pytest.param(200, "normal", id="200"),
    pytest.param(300, "normal", id="300"), (32, "integers"),
    (128, "integers"), (128, "quarters"), (100, "quarters")])
def test_gj_twin_matches_jax_kernel(n, kind, pivot):
    """Raw kernel outputs: pos identical, ok equal, pivot-order inverse
    within tolerance; also on tie-heavy inputs, where the packed key's
    tie-break by row decides the pivots: integers in [-3, 3] (exact ties
    in |column|) and quarter steps plus 1e-3 noise (values equal in the
    key's kept bits)."""
    if kind == "normal":
        a = _inputs(n, pivot)
    else:
        rng = np.random.default_rng(n)
        if kind == "integers":
            a = rng.integers(-3, 4, (3, n, n)).astype(np.float32)
        else:
            a = (rng.integers(-8, 9, (3, n, n)) / 4
                 + 1e-3 * rng.standard_normal((3, n, n))).astype(np.float32)
        if not pivot:
            a += n * np.eye(n, dtype=np.float32)
    a = _pad(a)
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


# K1's cluster branch: (m, C for a batch that fills the card, C for one
# matrix). The per-CTA count is the source's cluster_smem_bytes.
CLUSTER_CASES = [(256, 2, 8), (384, 4, 8), (512, 8, 8), (640, 16, 16)]


@pytest.mark.parametrize("m,c_full,c_one", CLUSTER_CASES)
def test_cluster_geometry(m, c_full, c_one):
    """C, the rows a CTA owns and its shared memory against one CTA's
    232,448 bytes, at a batch that fills the card (C the smallest that
    fits) and at one matrix (C grown, to at most 8 but where m needs 16);
    at most 128 rows a CTA, every CTA the same share."""
    for bsz, c in ((512, c_full), (1, c_one)):
        geo = tfused.cluster_geometry(m, bsz)
        assert geo.cluster == c and geo.rows * c == m and geo.rows <= 128
        assert geo.threads == 512
        rows = m // c
        want = (rows * m * 4 + 2 * c * (4 * m + 16) + 2 * 4 * m + 16
                + 4 * m + 36 * 4)
        assert geo.smem == tfused.cluster_smem_bytes(m, c) == want
        assert geo.smem <= 232448
    smaller = c_full // 2
    if smaller >= 2 and m // smaller <= 128:
        assert tfused.cluster_smem_bytes(m, smaller) > 232448


def test_cluster_geometry_raises():
    """No cluster for m outside 256 .. 640 or off the 128 grid, and none
    for m = 640 when only the portable 8 CTAs are allowed."""
    for m in (128, 300, 768):
        with pytest.raises(ValueError):
            tfused.cluster_geometry(m)
    with pytest.raises(ValueError, match="fits no cluster"):
        tfused.cluster_geometry(640, max_cluster=8)
    assert tfused.cluster_geometry(512, max_cluster=8).cluster == 8


class _FakeLib:
    """Stands in for the CUDA library on the CPU: admits every cluster
    (7 resident) and records the launches."""

    def __init__(self):
        self.calls = []

    def matinv_fused_clusters(self, m, cluster, smem, out):
        import ctypes
        ctypes.c_int.from_address(out).value = 7
        return 0

    def matinv_fused_gj(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("bsz,m", [(512, 256), (64, 640), (3, 128)])
def test_gj_kernel_allocates_no_workspace(bsz, m, monkeypatch):
    """K1's launch, run on the CPU against a stand-in library and meta
    tensors: it allocates its outputs and nothing else (no (B, m, 2m)
    workspace), and passes the cluster geometry of cluster_geometry."""
    from types import SimpleNamespace

    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    lib = _FakeLib()
    allocated = []
    real_empty, real_like = torch.empty, torch.empty_like

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        allocated.append(tuple(out.shape))
        return out

    def empty_like(x, **kw):
        out = real_like(x, **kw)
        allocated.append(tuple(out.shape))
        return out

    monkeypatch.setattr(cuda_build, "load", lambda: lib)
    monkeypatch.setattr(tfused, "_plans", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    a = real_empty((bsz, m, m), device="meta")
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    before = tfused.gj_kernel.launches
    tfused._launch(a, True)
    assert tfused.gj_kernel.launches == before + 1
    assert sorted(allocated) == sorted([(bsz, m, m), (bsz, m), (bsz,)])
    (args,) = lib.calls
    assert args[4:8] == (bsz, m, 1, 0)
    if m == 128:
        assert args[8:10] == (0, 0)
    else:
        geo = tfused.cluster_geometry(m, bsz)
        assert args[8:10] == (geo.cluster, geo.smem)


def _round_once(x: float, f: float, v: float) -> float:
    """x - f v rounded once to float32 (ties to even), from the exact
    rational value."""
    from fractions import Fraction
    exact = Fraction(x) - Fraction(f) * Fraction(v)
    lo = np.float32(float(exact))          # within an ulp of it
    best = None
    for c in (np.nextafter(lo, np.float32(-np.inf)), lo,
              np.nextafter(lo, np.float32(np.inf))):
        key = (abs(Fraction(float(c)) - exact), int(c.view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, float(c))
    return best[1]


def test_fms_rounds_once():
    """The twins' x - f v rounds once, as an FMA: on inputs where rounding
    the float64 difference to float32 rounds twice and lands on the other
    side of a tie (found by search; the first two differ from a plain
    float64 emulation), and on random and integer-valued inputs, against
    the exact rational value."""
    cases = [(1657454720.0, 1.5891950130462646, -40.2719612121582),
             (1655131392.0, 1.798779845237732, -35.579673767089844),
             (2074533248.0, 1.7825062274932861, -35.904502868652344)]
    rng = np.random.default_rng(7)
    cases += [tuple(float(np.float32(t)) for t in rng.standard_normal(3))
              for _ in range(300)]
    cases += [(float(rng.integers(-50, 50)),
               float(np.float32(1 / rng.integers(1, 9))),
               float(rng.integers(-9, 9))) for _ in range(300)]
    x, f, v = (torch.tensor(c, dtype=torch.float32) for c in zip(*cases))
    got = tfused._fms(x, f, v)
    want = torch.tensor([_round_once(*c) for c in cases],
                        dtype=torch.float32)
    assert torch.equal(got, want)
    plain = (x.double() - f.double() * v.double()).float()
    assert not torch.equal(plain[:2], want[:2])
