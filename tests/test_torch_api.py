"""The port's slice as a whole on ``device="cpu"``: the flat-vector API and
``inverse`` against the JAX package, and the reference's contract cases
(the spec of tests/test_api.py).

Tolerances: values within 1e-4 in max-abs relative difference against
the JAX package on standard_normal input (measured 0.0: both run the
same fused-route arithmetic), FP64 spec within 1e-12 (measured 0.0),
residual gates as the JAX package's own tests set them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gpu_matrix_inversion_tpu as jmi  # noqa: E402
import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix, well_conditioned_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)

CPU = {"device": "cpu"}


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", [128, 256])
def test_matrix_inv_32_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)).astype(np.float32)
    want = jmi.matrix_inv_32(a.reshape(-1), n)
    got = tmi.matrix_inv_32(a.reshape(-1), n, **CPU)
    assert got.shape == (n * n,) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("n", [128, 256])
def test_matrix_inv_32_hollow_residual(n):
    """The reference's protocol input: both packages meet the 1e-5 gate."""
    a = hollow_random_matrix(n, seed=n + 1)
    got = tmi.matrix_inv_32(a.reshape(-1), n, **CPU)
    want = jmi.matrix_inv_32(a.reshape(-1), n)
    assert relative_residual(a, got.reshape(n, n)) < 1e-5
    assert relative_residual(a, want.reshape(n, n)) < 1e-5


@pytest.mark.parametrize("case", ["order_zero", "order_negative",
                                  "non_square", "singular", "nan"])
def test_empty_vector_contract(case):
    """Every failure returns an empty vector (tests/test_api.py cases)."""
    flat, order = {
        "order_zero": ([1.0, 2.0, 3.0, 4.0], 0),
        "order_negative": ([1.0, 2.0, 3.0, 4.0], -5),
        "non_square": ([1.0, 2.0, 3.0], 2),
        "singular": (np.ones(64, np.float32), 8),
        "nan": (np.where(np.eye(8) > 0, np.nan, 1.0).reshape(-1), 8),
    }[case]
    out = tmi.matrix_inv_32(flat, order, **CPU)
    assert out.size == 0 and out.dtype == np.float32
    assert jmi.matrix_inv_32(flat, order).size == 0


def test_fp32_paths_agree_and_small_orders():
    n = 48
    a = hollow_random_matrix(n, seed=7)
    out = tmi.matrix_inv_32(a.reshape(-1), n, **CPU)
    np.testing.assert_array_equal(
        out, tmi.matrix_inversion_fp32(a.reshape(-1), n, **CPU))
    np.testing.assert_allclose(tmi.matrix_inv_32([4.0], 1, **CPU), [0.25])
    out2 = tmi.matrix_inv_32([1.0, 2.0, 3.0, 4.0], 2, **CPU)
    np.testing.assert_allclose(out2.reshape(2, 2),
                               np.linalg.inv([[1.0, 2.0], [3.0, 4.0]]),
                               rtol=1e-5)
    np.testing.assert_array_equal(tmi.matrix_inv_32(a, n, **CPU), out)


def test_matrix_inversion_fp64_matches_jax():
    """n = 64 FP64 takes the spec route in both packages."""
    n = 64
    a = hollow_random_matrix(n, seed=8, dtype=np.float64)
    got = tmi.matrix_inversion_fp64(a.reshape(-1), n, **CPU)
    want = jmi.matrix_inversion_fp64(a.reshape(-1), n)
    assert got.dtype == np.float64
    assert _rel(got, want) <= 1e-12
    assert relative_residual(a, got.reshape(n, n)) < 1e-14


def test_no_pivots_contract():
    n = 32
    good = well_conditioned_matrix(n, seed=9, dtype=np.float64)
    out = tmi.matrix_inversion_no_pivots(good.reshape(-1), n, **CPU)
    assert relative_residual(good, out.reshape(n, n)) < 1e-10
    hollow = hollow_random_matrix(n, seed=9, dtype=np.float64)
    assert tmi.matrix_inversion_no_pivots(hollow.reshape(-1), n,
                                          **CPU).size == 0


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spec_matches_jax(dtype, pivot):
    """ops/gauss_jordan (method="spec") against the JAX spec."""
    import jax.numpy as jnp
    n = 40
    a = well_conditioned_matrix(n, seed=4, dtype=dtype)
    a = np.stack([a, hollow_random_matrix(n, seed=5, dtype=dtype)])
    if not pivot:
        a = a[:1]
    want, want_ok = jmi.gauss_jordan_inverse(jnp.asarray(a), pivot=pivot)
    got, ok = tmi.inverse(torch.from_numpy(a), method="spec", pivot=pivot)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert _rel(got, want) <= (1e-4 if dtype == np.float32 else 1e-12)


def test_bench_returns_res():
    n = 32
    a = hollow_random_matrix(n, seed=10)
    res = tmi.fp32_bench(a.reshape(-1), n, **CPU)
    assert res.ok
    assert res.inversa32 is not None and res.inversa32.size == n * n
    for key in ("buffers", "compile", "total_compute", "get_inverted",
                "total"):
        assert key in res.times
    assert len(res.times_vector()) == 10
    res64 = tmi.fp64_bench(a.astype(np.float64).reshape(-1), n, **CPU)
    assert res64.ok and res64.inversa64.size == n * n
    assert not tmi.fp32_bench([1.0], 2, **CPU).ok
    good = well_conditioned_matrix(24, seed=12, dtype=np.float64)
    resnp = tmi.no_pivots_bench(good.reshape(-1), 24, **CPU)
    assert resnp.ok and len(resnp.times_vector(no_pivot=True)) == 12


def test_strict_identity_verify():
    """The opt-in identity self-check passes a good inverse and catches a
    finite but numerically singular one (a Hilbert block)."""
    n = 48
    a = hollow_random_matrix(n, seed=11)
    res = tmi.fp32_bench(a.reshape(-1), n, strict_verify=True, **CPU)
    assert res.ok and res.identity_error < 1e-3
    i = np.arange(n)
    hil = (1.0 / (1.0 + i[:, None] + i[None, :])).astype(np.float32)
    res = tmi.fp32_bench(hil.reshape(-1), n, strict_verify=True, **CPU)
    assert res.identity_error > 1e-2 and not res.ok


def test_verbose_fp32_prints_report(capsys):
    n = 16
    a = hollow_random_matrix(n, seed=12)
    out = tmi.matrix_inversion_fp32(a.reshape(-1), n, verbose=True, **CPU)
    assert out.size == n * n
    text = capsys.readouterr().out
    assert "device:" in text and "total_compute" in text and "ok" in text


def test_matrix_multiply_matches_jax():
    n = 24
    a = hollow_random_matrix(n, seed=11)
    inv = tmi.matrix_inv_32(a.reshape(-1), n, **CPU)
    err = tmi.matrix_multiply(inv, a.reshape(-1), n, **CPU)
    assert abs(err) < 1e-2
    assert abs(err - jmi.matrix_multiply(inv, a.reshape(-1), n)) < 1e-4
    assert np.isnan(tmi.matrix_multiply([1.0], a.reshape(-1), n, **CPU))


@pytest.mark.parametrize("n,batched,method", [
    (100, False, "fused"), (600, False, "blocked"), (600, True, "fused"),
    (700, True, "blocked")])
def test_auto_routes_like_jax(n, batched, method):
    """The port's auto routing takes the JAX package's route."""
    import jax.numpy as jnp
    from gpu_matrix_inversion_tpu.models.solver import _resolve as jresolve
    from gpu_matrix_inversion_tpu_torch.models.solver import _resolve
    shape = (2, n, n) if batched else (n, n)
    assert _resolve("auto", torch.empty(shape)) == method
    assert jresolve("auto", jnp.empty(shape, jnp.float32)) == method
    assert _resolve("auto", torch.empty(40, 40, dtype=torch.float64)) == (
        jresolve("auto", jnp.empty((40, 40), jnp.float64)))


@pytest.mark.parametrize("n,dtype", [(600, "float64"), (20000, "float32")])
def test_auto_routes_past_the_first_slice_like_jax(n, dtype):
    """FP64 at n = 600 and FP32 at n = 20000 route to ``blocked`` in both
    packages, and the blocked geometry sends them to the FP64 f32-search
    tier and to the bf16-search split path (b = 64, m = 20032). Shapes
    only: meta tensors and ShapeDtypeStructs allocate nothing."""
    import jax
    import jax.numpy as jnp
    from gpu_matrix_inversion_tpu.models.solver import _resolve as jresolve
    from gpu_matrix_inversion_tpu.ops import blocked as jblocked
    from gpu_matrix_inversion_tpu_torch.models.solver import _resolve
    from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked
    a = torch.empty((n, n), dtype=getattr(torch, dtype), device="meta")
    ja = jax.ShapeDtypeStruct((n, n), getattr(jnp, dtype))
    assert _resolve("auto", a) == jresolve("auto", ja) == "blocked"
    got = tblocked._select_block_params(n, 256, a.dtype, False)
    assert got == jblocked._select_block_params(n, 256, ja.dtype, False)
    b, use_kernels, search_bf16 = got
    m = tblocked._round_up(n, b)
    if dtype == "float64":
        assert not use_kernels and b * m <= 128 * 8192 and b % 8 == 0
    else:
        assert (b, m, use_kernels, search_bf16) == (64, 20032, True, True)
        assert not tblocked._emit_fused(m, b, use_kernels, search_bf16)


@pytest.mark.parametrize("method", ["cholesky", "sharded"])
def test_unported_methods_raise(method):
    """Both routes are ported now. ``sharded`` without a mesh and without
    an initialized ``torch.distributed`` world raises ``ValueError`` (it
    never runs on one device on the quiet; ``test_torch_sharded.py`` runs
    it on gloo ranks); ``cholesky`` inverts (potri of I is I, exactly)."""
    if method == "sharded":
        with pytest.raises(ValueError, match="process group"):
            tmi.inverse(torch.eye(8), method=method)
    else:
        inv, ok = tmi.inverse(torch.eye(8), method=method)
        assert bool(ok) and torch.equal(inv, torch.eye(8))
    with pytest.raises(ValueError):
        tmi.inverse(torch.eye(8), method="nope")


@pytest.mark.parametrize("shape", [(0, 8, 8), (3, 0, 0), (0, 0)])
def test_empty_input_raises_in_both_packages(shape):
    """Both packages refuse an empty input: the port with one ValueError,
    raised before any route (so on the CPU and the card alike), the JAX
    package with its own error. The flat API's order <= 0 contract
    (test_empty_vector_contract) returns an empty vector before either."""
    with pytest.raises(ValueError, match="empty input"):
        tmi.inverse(torch.zeros(shape))
    with pytest.raises(ValueError, match="empty input"):
        tmi.inverse(torch.zeros(shape), method="blocked")
    with pytest.raises(Exception):
        jmi.inverse(np.zeros(shape, dtype=np.float32))


@pytest.mark.parametrize("flag", [False, True])
def test_precision_leaves_tf32_flag_unchanged(flag):
    """precision="high" runs the blocked GEMMs under TF32 inside a scope
    that restores the process-global flag; "highest" forces FP32."""
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    try:
        matmul.allow_tf32 = flag
        a = torch.from_numpy(hollow_random_matrix(96, seed=2))
        for precision in ("high", "highest", "default"):
            inv, ok = tmi.inverse(a, method="blocked", block_size=32,
                                  precision=precision)
            assert bool(ok)
            assert matmul.allow_tf32 is flag
        with matmul_precision("highest"):
            assert matmul.allow_tf32 is False
        with matmul_precision("high"):
            assert matmul.allow_tf32 is True
        assert matmul.allow_tf32 is flag
        with pytest.raises(ValueError):
            tmi.inverse(a, method="blocked", precision="fast")
    finally:
        matmul.allow_tf32 = prev


def test_cuda_default_does_not_fall_back_to_cpu():
    """Without a card the default device raises; nothing carries on."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = hollow_random_matrix(8, seed=1)
    with pytest.raises((RuntimeError, AssertionError)):
        tmi.matrix_inv_32(a.reshape(-1), 8)
