"""Parity of the port's verification GEMM (kernel K7's plain twin,
``ops/matmul.py``), the Newton-Schulz family (``models/newton_schulz.py``),
``inverse(method="ns")``, ``InversionConfig`` and ``Inverter`` with the JAX
package, on the CPU.

Tolerances: ``tiled_matmul`` against the interpret-mode ``pallas_matmul``
within ``matmul.error_bound`` elementwise (both accumulate in fp32 in
different orders: k * 2^-24 * (|a| @ |b|) each, plus one bf16 spacing for
bf16 outputs); fp32 products within ``matmul.fp32_error_bound`` of the
float64 product, which TF32 and bf16-operand products must exceed on more
than half the elements. Newton-Schulz: ok flags equal to the JAX package's on
test_matmul_ns.py's cases, residuals under the same gates (1e-5 where
converged, > 1e-3 where not), values within 1e-4 in max-abs relative
difference where converged (measured <= 2e-7: both sum FP32 GEMMs in other
orders). Inverter: ok equal and values within 1e-4 (test_torch_blocked.py's
TOL) of the JAX Inverter at n = 200.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gpu_matrix_inversion_tpu.models import solver as jsolver  # noqa: E402
from gpu_matrix_inversion_tpu.models.newton_schulz import (  # noqa: E402
    newton_schulz_inverse as jns)
from gpu_matrix_inversion_tpu.ops.matmul import pallas_matmul  # noqa: E402
from gpu_matrix_inversion_tpu.utils.config import (  # noqa: E402
    InversionConfig as JConfig)
import gpu_matrix_inversion_tpu_torch as tmi  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (  # noqa: E402,E501
    newton_schulz_inverse as tns)
from gpu_matrix_inversion_tpu_torch.ops import matmul as tmatmul  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix, well_conditioned_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)

TOL = 1e-4


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


# test_matmul_ns.py's GEMM cases: (m, k, n, seed, bf16).
GEMM_CASES = {"300x200@200x150": (300, 200, 150, 0, False),
              "256x256@256x256": (256, 256, 256, 1, False),
              "bf16 192x160@160x128": (192, 160, 128, 2, True)}


@pytest.mark.parametrize("name", sorted(GEMM_CASES))
def test_tiled_matmul_twin_matches_pallas(name):
    m, k, n, seed, bf16 = GEMM_CASES[name]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if bf16:
        j = np.asarray(pallas_matmul(jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16), block=128),
                       dtype=np.float32)
        ta = torch.from_numpy(a).to(torch.bfloat16)
        tb = torch.from_numpy(b).to(torch.bfloat16)
    else:
        j = np.asarray(pallas_matmul(a, b, block=128))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    t = tmatmul.tiled_matmul(ta, tb)
    assert t.dtype == ta.dtype and t.shape == (m, n)
    diff = (t.float() - torch.from_numpy(np.array(j))).abs()
    assert bool((diff <= tmatmul.error_bound(ta, tb)).all())


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 values to TF32's 10-bit mantissa (to nearest, ties to
    even), as a TF32 tensor-core product reads its operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


@pytest.mark.parametrize("name", [k for k, v in sorted(GEMM_CASES.items())
                                  if not v[4]])
def test_fp32_error_bound_tells_fp32_from_reduced_precision(name):
    """The fp32 check that holds K7 on the card: the twin and pallas_matmul
    lie within fp32_error_bound of the float64 product; a product of
    TF32-rounded operands and one of bf16-rounded operands exceed it on
    most elements."""
    m, k, n, seed, _ = GEMM_CASES[name]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = ta.double() @ tb.double()
    tol = tmatmul.fp32_error_bound(ta, tb)
    for good in (tmatmul.tiled_matmul(ta, tb),
                 torch.from_numpy(np.array(pallas_matmul(a, b, block=128)))):
        assert bool(((good.double() - exact).abs() <= tol).all())
    for bad in (_round_tf32(ta) @ _round_tf32(tb),
                ta.bfloat16().float() @ tb.bfloat16().float()):
        over = (bad.double() - exact).abs() > tol
        assert float(over.double().mean()) > 0.5


@pytest.mark.parametrize("case", ["mismatch", "three_d"])
def test_tiled_matmul_rejects_bad_shapes(case):
    a, b = ((np.zeros((3, 4), np.float32), np.zeros((5, 6), np.float32))
            if case == "mismatch" else
            (np.zeros((2, 3, 4), np.float32), np.zeros((4, 5), np.float32)))
    with pytest.raises(ValueError):
        pallas_matmul(a, b)
    with pytest.raises(ValueError):
        tmatmul.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))


def test_tiled_matmul_rejects_other_dtypes():
    a = np.ones((4, 4))                      # float64, as x64 mode keeps it
    with pytest.raises(NotImplementedError):
        pallas_matmul(a, a)
    with pytest.raises(NotImplementedError):
        tmatmul.tiled_matmul(torch.from_numpy(a), torch.from_numpy(a))
    with pytest.raises(TypeError):
        tmatmul.tiled_matmul(torch.ones(4, 4),
                             torch.ones(4, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stride_pad_rule(dtype):
    """K7 reads rows in 16-byte units: an operand needs the stride-pad copy
    when its row stride or its base address is off 16 bytes; one with no
    elements never does. The shapes of the on-card checks."""
    per = 16 // torch.empty((), dtype=dtype).element_size()

    def op(rows, cols, offset=0):
        flat = torch.zeros(offset + rows * cols, dtype=dtype)
        return flat[offset:].view(rows, cols)

    assert not tmatmul.needs_stride_pad(op(3, 2 * per))
    assert tmatmul.needs_stride_pad(op(3, 2 * per + 1))
    assert tmatmul.needs_stride_pad(op(3, 2 * per, offset=1))
    assert not tmatmul.needs_stride_pad(op(64, 0))
    assert not tmatmul.needs_stride_pad(op(0, 48))
    # 300 x 200 @ 200 x 150: B's rows are 600 (fp32) or 300 (bf16) bytes.
    assert not tmatmul.needs_stride_pad(op(300, 200))
    assert tmatmul.needs_stride_pad(op(200, 150))
    # 1000 x 1001 @ 1001 x 999: both; 4096^2: neither.
    assert tmatmul.needs_stride_pad(op(1000, 1001))
    assert tmatmul.needs_stride_pad(op(1001, 999))
    assert not tmatmul.needs_stride_pad(op(4096, 4096))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stride_pad_one_row_view(dtype):
    """A one-row view of a wider row counts as contiguous whatever its row
    stride, so the wrapper's ``contiguous()`` keeps it. With a stride and
    base that are aligned but a length that is not, K7 would read the
    wider row's next elements (inf here) in the row's last 16-byte unit:
    it takes the copy, whose tail is zeros. With an aligned length it
    needs none."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    wide = torch.full((1, 4 * per), float("inf"), dtype=dtype)
    view = wide[:, :2 * per + 1]
    assert view.is_contiguous() and view.contiguous() is view
    assert view.stride(0) == 4 * per
    assert tmatmul.needs_stride_pad(view)
    assert not tmatmul.needs_stride_pad(wide[:, :2 * per])
    padded = tmatmul.stride_padded(view)
    row = padded.as_strided((1, padded.stride(0)), (padded.stride(0), 1))
    assert torch.equal(padded, view) and not bool(row[:, 2 * per + 1:].any())


@pytest.mark.parametrize("shape,offset", [((200, 150), 0), ((7, 1001), 0),
                                          ((5, 16), 1), ((1, 3), 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stride_padded_copy(dtype, shape, offset):
    """The stride-pad copy keeps the logical shape and every value, pads
    each row with zeros to a 16-byte stride on an aligned base, and so
    gives K7 what it reads in place: aligned rows whose last 16-byte unit
    holds zeros past the row."""
    rows, cols = shape
    rng = np.random.default_rng(rows * cols)
    flat = torch.from_numpy(rng.standard_normal(offset + rows * cols).astype(
        np.float32)).to(dtype)
    x = flat[offset:].view(rows, cols)
    p = tmatmul.stride_padded(x)
    ld = p.stride(0)
    assert p.shape == x.shape and p.dtype == dtype and p.stride(1) == 1
    assert (ld * p.element_size()) % 16 == 0 and cols <= ld < cols + 16
    assert torch.equal(p, x)
    full = p.as_strided((rows, ld), (ld, 1))
    assert not bool(full[:, cols:].any())
    assert p.data_ptr() % 16 == 0
    # Its stride and base pass the rule; only a ragged row length, whose
    # tail the rule cannot see is zeros, would ask for another copy.
    per = 16 // p.element_size()
    assert tmatmul.needs_stride_pad(p) == bool(cols % per)


def _ill_conditioned(n=192, seed=93):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * np.logspace(0, -7, n)) @ q.T).astype(np.float32)


# test_matmul_ns.py's Newton-Schulz cases: name -> (matrix, iters, mixed,
# converged).
def _ns_case(name):
    return {
        "well_conditioned": lambda: (well_conditioned_matrix(96, seed=90),
                                     25, False, True),
        "mixed": lambda: (well_conditioned_matrix(128, seed=91), 30, True,
                          True),
        "singular": lambda: (np.ones((32, 32), np.float32), 10, False,
                             False),
        "unconverged": lambda: (_ill_conditioned(), 8, False, False),
        "unconverged_scaled_down": lambda: (
            _ill_conditioned() * np.float32(1e-6), 8, False, False),
        "converged_scaled_down": lambda: (
            (well_conditioned_matrix(96, seed=94) * 1e-6).astype(np.float32),
            30, False, True),
        "converged_scaled_up": lambda: (
            (well_conditioned_matrix(96, seed=94) * 1e6).astype(np.float32),
            30, False, True),
        "fp64": lambda: (well_conditioned_matrix(64, seed=95,
                                                 dtype=np.float64),
                         30, False, True),
    }[name]()


@pytest.mark.parametrize("name", ["well_conditioned", "mixed", "singular",
                                  "unconverged", "unconverged_scaled_down",
                                  "converged_scaled_down",
                                  "converged_scaled_up", "fp64"])
def test_newton_schulz_matches_jax(name):
    """ok equal to the JAX package's (the scale-invariant gate: rescaling A
    never flips it), residuals under the same gates."""
    a, iters, mixed, converged = _ns_case(name)
    j_x, j_ok = jns(jnp.asarray(a), iters=iters, mixed=mixed)
    t_x, t_ok = tns(torch.from_numpy(a), iters=iters, mixed=mixed)
    assert t_x.dtype == torch.from_numpy(a).dtype
    assert bool(t_ok) == bool(j_ok) == converged
    t_res = relative_residual(a, t_x.numpy())
    j_res = relative_residual(a, np.asarray(j_x))
    if converged:
        gate = 1e-12 if a.dtype == np.float64 else 1e-5
        assert t_res < gate and j_res < gate
        assert _rel(t_x.numpy(), j_x) <= TOL
    elif name.startswith("unconverged"):
        assert t_res > 1e-3 and j_res > 1e-3


def test_newton_schulz_batched():
    """A (2, n, n) batch: per-matrix ok, the first member singular."""
    a = np.stack([np.ones((48, 48), np.float32),
                  well_conditioned_matrix(48, seed=96)])
    x, ok = tns(torch.from_numpy(a))
    assert x.shape == a.shape and ok.tolist() == [False, True]
    with pytest.raises(ValueError):
        tns(torch.ones(3, 4))


def test_inverse_ns_method_matches_jax():
    a = well_conditioned_matrix(64, seed=92)
    j_x, j_ok = jsolver.inverse(a, method="ns")
    t_x, t_ok = tmi.inverse(torch.from_numpy(a), method="ns")
    assert bool(t_ok) == bool(j_ok) and bool(t_ok)
    assert relative_residual(a, t_x.numpy()) < 1e-5
    assert _rel(t_x.numpy(), j_x) <= TOL


ENV = {"MATINV_DTYPE": "float64", "MATINV_PIVOT": "0",
       "MATINV_BLOCK_SIZE": "64", "MATINV_METHOD": "ns",
       "MATINV_SEARCH_BF16": "yes", "MATINV_REFINE_ITERS": "2",
       "MATINV_PRECISION": "high"}


@pytest.mark.parametrize("overrides", [{}, {"pivot": True},
                                       {"method": "lu", "seed": 7}])
def test_config_from_env_matches_jax(overrides, monkeypatch):
    for key, val in ENV.items():
        monkeypatch.setenv(key, val)
    t = tmi.InversionConfig.from_env(**overrides)
    j = JConfig.from_env(**overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.validate() is t


@pytest.mark.parametrize("bad", [{"dtype": "float16"}, {"method": "nope"},
                                 {"precision": "low"}, {"block_size": 0},
                                 {"repeat": 0}])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JConfig(**bad).validate()
    with pytest.raises(ValueError):
        tmi.InversionConfig(**bad).validate()


@pytest.mark.parametrize("method", ["blocked", "ns"])
def test_inverter_matches_jax(method):
    """Inverter at n = 200 against the JAX Inverter: the blocked route with
    refine_iters=1 (polished twice, as in the reference; b = 32 keeps the
    interpret-mode kernel quick) and ns."""
    a = (hollow_random_matrix(200, seed=97) if method == "blocked"
         else well_conditioned_matrix(200, seed=97))
    cfg = dict(method=method, refine_iters=1, block_size=32)
    j_x, j_ok = jsolver.Inverter(**cfg).inverse(a)
    inv = tmi.Inverter(**cfg, device="cpu")
    t_x, t_ok = inv.inverse(a)
    assert t_x.device.type == "cpu" and t_x.dtype == torch.float32
    assert bool(t_ok) == bool(j_ok) and bool(t_ok)
    assert relative_residual(a, t_x.numpy()) < 1e-6
    assert _rel(t_x.numpy(), j_x) <= TOL


def test_inverter_config_and_solve():
    """A config object with overrides; solve threads pivot, block_size and
    refine_iters (tests/test_solver.py's case); the cholesky route inverts
    an SPD matrix, and sharded, not ported yet, raises."""
    n = 96
    a = hollow_random_matrix(n, seed=300, dtype=np.float64) + np.eye(n) * 1e3
    b = np.random.default_rng(1).standard_normal((n, 2))
    cfg = tmi.InversionConfig(dtype="float64", method="spec")
    inv = tmi.Inverter(cfg, method="lu", pivot=False, block_size=32,
                       refine_iters=1, device="cpu")
    assert inv.config.method == "lu" and cfg.method == "spec"
    x, ok = inv.solve(a, b)
    assert bool(ok.all())
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-9)
    spd = a @ a.T
    x, ok = tmi.Inverter(dtype="float64", method="cholesky",
                         device="cpu").inverse(spd)
    assert bool(ok)
    np.testing.assert_allclose(x.numpy() @ spd, np.eye(n), atol=1e-9)
    with pytest.raises(NotImplementedError):
        tmi.Inverter(method="sharded", device="cpu").inverse(a)
    with pytest.raises(ValueError):
        tmi.Inverter(method="nope", device="cpu")
