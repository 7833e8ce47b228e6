"""Parity of the port's lockstep route (kernel K6's plain twin and the
lockstep driver, ``ops/lockstep.py``) with the JAX package, on the CPU.

Tolerances: pivot rows identical and ok flags equal everywhere. K6's twin
against the interpret-mode ``_panel_factor_lockstep``: C^T within 1e-4 in
max-abs relative difference (``test_torch_blocked.py``'s TOL; the twin is
K2's, which rounds as XLA's CPU code does). The lockstep route against
``_lockstep_inverse_jit`` on test_lockstep.py's inputs: each inverse
within n * kappa(A) * 2^-24 of the JAX one in the same relative measure,
the first-order forward-error bound of an inverse with backward error
n * u, and both raw residuals <= 1e-4. The drivers' GEMMs sum in
different orders (XLA's dot against PyTorch's addmm in FP32 at
``precision="high"``; float64 against FP32 accumulation at
``"highest"``), so they are not bit-identical at these shapes: measured
0.05 to 17 kappa * 2^-24 (a hollow member of kappa 6.2e6 differs by
2.2e-2, one of kappa 4.5e3 by 3.7e-4, the no-pivot members of kappa 45
by 4.5e-5). The port's
own contract, lockstep equal to the per-matrix route, is bit for bit. JAX
calls stay at the sizes of ``tests/test_lockstep.py`` (interpret mode is
slow).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gpu_matrix_inversion_tpu.ops import lockstep as jlockstep  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.ops import lockstep as tlockstep  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)

TOL = 1e-4


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


# test_lockstep_gate's cases: (opted in, nbatch, n, block_size, fp64,
# search_bf16).
GATE_CASES = [(False, 16, 1024, 128, False, False),
              (True, 16, 1024, 128, False, False),
              (True, 16, 2048, 128, False, False),
              (True, 16, 8192, 128, False, False),
              (True, 3, 1024, 128, False, False),
              (True, 1, 1024, 128, False, False),
              (True, 16, 1024, 128, True, False),
              (True, 16, 1024, 128, False, True)]


@pytest.mark.parametrize("case", GATE_CASES)
def test_lockstep_k_matches_jax(case, monkeypatch):
    """The copied gate picks the k the JAX package picks (8, 4, 0, 3, ...),
    and is off unless MATINV_LOCKSTEP=1."""
    on, nbatch, n, bs, fp64, bf16 = case
    if on:
        monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    else:
        monkeypatch.delenv("MATINV_LOCKSTEP", raising=False)
    j = jlockstep._lockstep_k(nbatch, n, bs,
                              jnp.float64 if fp64 else jnp.float32,
                              search_bf16=bf16)
    t = tlockstep._lockstep_k(nbatch, n, bs,
                              torch.float64 if fp64 else torch.float32,
                              search_bf16=bf16)
    assert t == j


def _jax_lockstep_panel(strips, kb, used, *, pivot):
    k, m, b = strips.shape
    p, ct, ok = jlockstep._panel_factor_lockstep(
        jnp.asarray(strips), jnp.int32(kb),
        jnp.asarray(used[:, :, None].astype(np.float32)), k=k, m=m, b=b,
        pivot=pivot, interpret=True)
    return np.asarray(p), np.asarray(ct), np.asarray(ok)


@pytest.mark.parametrize("case", ["empty_mask", "prior_panel", "no_pivot"])
def test_lockstep_twin_matches_jax(case):
    """K6's twin against the interpret-mode lockstep kernel at k = 2,
    m = 256, b = 64: empty masks, each matrix's own prior panel consumed,
    and pivot=False at kb = 64."""
    k, m, b = 2, 256, 64
    rng = np.random.default_rng(21)
    strips = rng.standard_normal((k, m, b)).astype(np.float32)
    used = np.zeros((k, m), np.int32)
    kb, pivot = 0, True
    if case == "prior_panel":
        first, _, _ = _jax_lockstep_panel(strips, 0, used, pivot=True)
        for i in range(k):
            used[i, first[i]] = 1
        kb = b
    elif case == "no_pivot":
        kb, pivot = b, False
    j_p, j_ct, j_ok = _jax_lockstep_panel(strips, kb, used, pivot=pivot)
    t_p, t_ct, t_ok = tlockstep.lockstep_factor(
        torch.from_numpy(np.ascontiguousarray(strips.transpose(0, 2, 1))),
        kb, torch.from_numpy(used), pivot=pivot)
    np.testing.assert_array_equal(t_p.numpy(), j_p)
    assert t_ok.tolist() == j_ok.tolist() == [True] * k
    assert t_ct.shape == (k, b, m)
    assert _rel(t_ct.numpy(), j_ct) <= TOL
    if case == "prior_panel":
        for i in range(k):
            assert not np.isin(t_p[i].numpy(), np.flatnonzero(used[i])).any()


def test_lockstep_factor_rejects_bad_input():
    strips = torch.zeros((2, 16, 64))
    used = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        tlockstep.lockstep_factor(strips[0], 0, used, pivot=True)
    with pytest.raises(TypeError):
        tlockstep.lockstep_factor(strips, 0, used[:1], pivot=True)
    with pytest.raises(TypeError):
        tlockstep.lockstep_factor(strips.double(), 0, used, pivot=True)
    with pytest.raises(ValueError):
        tlockstep.lockstep_factor(strips, 60, used, pivot=True)


# test_lockstep.py's shapes: an odd batch, n not a multiple of b and a tail
# group; and the no-pivot case with diagonally dominant members.
ROUTE_CASES = {
    "pivot": dict(bsz=5, n=200, b=32, k=2, group=4, pivot=True, seed=50),
    "no_pivot": dict(bsz=4, n=96, b=16, k=4, group=3, pivot=False, seed=60),
}


def _route_batch(c):
    batch = np.stack([hollow_random_matrix(c["n"], seed=c["seed"] + i)
                      for i in range(c["bsz"])])
    if not c["pivot"]:
        batch += np.eye(c["n"], dtype=np.float32) * 500.0
    return batch


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_lockstep_route_matches_jax(name, precision):
    c = ROUTE_CASES[name]
    batch = _route_batch(c)
    j_inv, j_ok = jlockstep._lockstep_inverse_jit(
        jnp.asarray(batch), pivot=c["pivot"], b=c["b"], k=c["k"],
        interpret=True, precision=precision, group_size=c["group"],
        refine=0)
    t_inv, t_ok = tlockstep.lockstep_inverse(
        torch.from_numpy(batch), pivot=c["pivot"], b=c["b"], k=c["k"],
        precision=precision, group_size=c["group"], refine=0)
    assert t_ok.tolist() == np.asarray(j_ok).tolist() == [True] * c["bsz"]
    j_inv = np.asarray(j_inv)
    for i in range(c["bsz"]):
        kappa = np.linalg.cond(batch[i].astype(np.float64))
        assert _rel(t_inv[i].numpy(), j_inv[i]) <= c["n"] * kappa * 2.0**-24
        assert relative_residual(batch[i], t_inv[i].numpy()) <= 1e-4
        assert relative_residual(batch[i], j_inv[i]) <= 1e-4


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_lockstep_equals_per_matrix(name, refine, monkeypatch):
    """The port's contract: blocked_inverse with MATINV_LOCKSTEP=1 equals
    the per-matrix route bit for bit, refine included, and meets the
    refined gate of test_blocked_inverse_batch_routes_lockstep."""
    c = ROUTE_CASES[name]
    x = torch.from_numpy(_route_batch(c))
    kwargs = dict(pivot=c["pivot"], block_size=c["b"],
                  group_size=c["group"], refine=refine)
    monkeypatch.delenv("MATINV_LOCKSTEP", raising=False)
    off, ok_off = tblocked.blocked_inverse(x, **kwargs)
    monkeypatch.setenv("MATINV_LOCKSTEP", "1")
    on, ok_on = tblocked.blocked_inverse(x, **kwargs)
    assert torch.equal(on, off)
    assert ok_on.tolist() == ok_off.tolist() == [True] * c["bsz"]
    if refine:
        for i in range(c["bsz"]):
            assert relative_residual(x[i].numpy(), on[i].numpy()) < 1e-5


def test_lockstep_flags_singular_member_only():
    """A rank-1 member: ok false for it alone, as in the JAX package."""
    batch = np.stack([hollow_random_matrix(64, seed=70 + i)
                      for i in range(4)])
    batch[2] = 1.0
    _, j_ok = jlockstep._lockstep_inverse_jit(
        jnp.asarray(batch), pivot=True, b=16, k=2, interpret=True,
        precision="highest", group_size=2, refine=0)
    _, t_ok = tlockstep.lockstep_inverse(
        torch.from_numpy(batch), pivot=True, b=16, k=2,
        precision="highest", group_size=2, refine=0)
    assert t_ok.tolist() == np.asarray(j_ok).tolist() == [True, True, False,
                                                          True]


@pytest.mark.parametrize("case", ["fp32_batch", "fp64_batch", "bf16_search",
                                  "single", "opted_out"])
def test_blocked_inverse_routes_lockstep(case, monkeypatch):
    """blocked_inverse takes the lockstep route exactly where the reference
    does (blocked.py:1175-1192): an fp32 batch on the kernels' route,
    without bf16 search, opted in; everything else loops per matrix."""
    calls = []
    real = tlockstep.lockstep_inverse

    def spy(*args, **kwargs):
        calls.append(kwargs["k"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tlockstep, "lockstep_inverse", spy)
    monkeypatch.setenv("MATINV_LOCKSTEP", "0" if case == "opted_out" else "1")
    rng = np.random.default_rng(22)
    a = torch.from_numpy(rng.standard_normal((3, 48, 48)).astype(np.float32))
    kwargs = {}
    if case == "fp64_batch":
        a = a.double()
    elif case == "bf16_search":
        kwargs["search_bf16"] = True
    elif case == "single":
        a = a[0]
    _, ok = tblocked.blocked_inverse(a, block_size=16, **kwargs)
    assert bool(ok.all())
    assert calls == ([3] if case == "fp32_batch" else [])
