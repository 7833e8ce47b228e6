"""Parity of the port's sharded route (``parallel/``) with the JAX package's,
on the CPU: the port on gloo ranks started by ``spawn_ranks`` (one spawn
per world size, each running all of its cases), the reference on the
virtual 8-device CPU mesh of ``tests/conftest.py``, at the sizes of
``tests/test_sharded.py``.

Both sides run the plain logical panel on a CPU mesh (full-precision first
max), so pivot orders agree; the port accumulates the window GEMMs in
float64 where the reference sums in fp32. Tolerances: ``ok`` flags equal
(on a non-finite input too); values within 1e-4 max-abs relative
difference (``test_torch_blocked.py``'s), 1e-12 for fp64; bf16 outputs
within 2^-8 of max|ref| (one bf16 rounding step of the largest element:
the fp32 results they round from differ by ~1e-5); the raw 768^2 batch
(kappa 2.5e5) held to the reference's own forward error, as its test says.
Measured gaps: 256 on 8 ranks refined 1.7e-5; 320 on 8 ranks 1.3e-5; 200
on 4 ranks 2.6e-5; (2, 4) batched at n = 64 2.9e-5; at n = 768 2.9e-3
(forward error against the float64 inverse: port 8.7e-4, reference
2.0e-3); bf16 1.4e-3 and 2.7e-3 on (2, 2); fp64 2.2e-13; ``solve``
8.7e-6. The whole file takes ~55 s on one worker. Port-only checks: the
pivot order is the same at d = 1, 2, 4 and 8; d = 1 is bit for bit the
blocked driver's plain route; one collective per group plus the slot
gather (a broadcast from each slot-holding rank) and the ``ok`` reduction;
a rank outside the live window runs no GEMM; ``auto`` takes a world only
for input on a device its backend serves, and input on another device
than the mesh's raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpu_matrix_inversion_tpu.models import solver as jsolver  # noqa: E402
from gpu_matrix_inversion_tpu.ops import blocked as jblocked  # noqa: E402
from gpu_matrix_inversion_tpu.parallel import make_device_mesh as jmesh  # noqa: E402,E501
from gpu_matrix_inversion_tpu.parallel import sharded as jsh  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models import solver as tsolver  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.ops import blocked as tblocked  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.parallel import launch  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.parallel import mesh as tmesh  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.parallel import sharded as tsh  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)

TOL = 1e-4
TOL64 = 1e-12
TOL_BF16 = 2.0 ** -8


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


A256 = hollow_random_matrix(256, seed=70)
A320 = hollow_random_matrix(320, seed=74)
A200 = hollow_random_matrix(200, seed=71)
A192 = hollow_random_matrix(192, seed=75)
A96 = hollow_random_matrix(96, seed=77)
A96B = hollow_random_matrix(96, seed=78)
A128_64 = hollow_random_matrix(128, seed=72, dtype=np.float64)
A_SOLVE = hollow_random_matrix(256, seed=41)
RHS = np.random.default_rng(42).standard_normal((256, 8)).astype(np.float32)
ONES = np.ones((64, 64), dtype=np.float32)
NONFINITE = A256.copy()
NONFINITE[3, 200] = np.inf
BATCH64 = np.stack([hollow_random_matrix(64, seed=s) for s in range(4)])
BATCH768 = np.stack([hollow_random_matrix(768, seed=80 + s)
                     for s in range(2)])
# 32768^2 stand-ins for the routing checks, with no storage to speak of:
# a CPU view of one element, and a tensor on the meta device.
BIG_CPU = torch.zeros(1).expand(32768, 32768)
BIG_META = torch.empty((32768, 32768), device="meta")


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _cases(d: int) -> dict:
    """The port's calls on a world of d ranks: name -> (fn, mesh shape,
    axis names, args, kwargs) for ``launch.run_calls``."""
    x = ((d,), ("x",))
    cases = {"raw256": (tsh._sharded_raw, *x, (A256,), dict(block_size=32))}
    if d == 2:
        cases.update(
            route_cpu=(tsolver._resolve, None, None, ("auto", BIG_CPU), {}),
            route_meta=(tsolver._resolve, None, None, ("auto", BIG_META),
                        {}))
    if d == 8:
        dp_tp = ((2, 4), ("dp", "tp"))
        cases.update(
            inv256=(tsh.sharded_blocked_inverse, *x, (A256,),
                    dict(block_size=32)),
            inv320=(tsh.sharded_blocked_inverse, *x, (A320,),
                    dict(block_size=16, group_size=4)),
            nonfinite=(tsh.sharded_blocked_inverse, *x, (NONFINITE,),
                       dict(block_size=32)),
            batched64=(tsh.sharded_batched_inverse, *dp_tp, (BATCH64,),
                       dict(block_size=16)),
            batched768=(tsh.sharded_batched_inverse, *dp_tp, (BATCH768,),
                        dict(block_size=128, group_size=3)))
    if d == 4:
        cases.update(
            inv200=(tsh.sharded_blocked_inverse, *x, (A200,),
                    dict(block_size=32)),
            ones64=(tsh.sharded_blocked_inverse, *x, (ONES,),
                    dict(block_size=16)),
            bf16=(tsh.sharded_blocked_inverse, *x, (_bf16(A96),),
                  dict(block_size=16)),
            bf16_batched=(tsh.sharded_batched_inverse, (2, 2), ("dp", "tp"),
                          (_bf16(np.stack([A96, A96B])),),
                          dict(block_size=16)),
            fp64=(tsh.sharded_blocked_inverse, *x, (A128_64,),
                  dict(block_size=16)),
            solve=(tsolver.solve, *x, (A_SOLVE, RHS),
                   dict(method="sharded")),
            refine0=(tsh.sharded_blocked_inverse, *x, (A192,),
                     dict(block_size=32, refine=0)),
            refine1=(tsh.sharded_blocked_inverse, *x, (A192,),
                     dict(block_size=32, refine=1)))
    return cases


@pytest.fixture(scope="module")
def world():
    """``world(d)``: every rank's results of ``_cases(d)``, one spawn per
    world size, cached for the module."""
    runs = {}

    def get(d: int) -> dict:
        if d not in runs:
            cases = _cases(d)
            per_rank = launch.spawn_ranks(d, launch.run_calls,
                                          list(cases.values()))
            runs[d] = {name: [rank[i] for rank in per_rank]
                       for i, name in enumerate(cases)}
        return runs[d]
    return get


def _replicated(results) -> tuple:
    """The result every rank returned, after checking they are equal (NaNs
    included)."""
    out = results[0]["out"]
    for other in results[1:]:
        for x, y in zip(out, other["out"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.float().numpy(),
                                          y.float().numpy())
    return out


def _jax_inverse(a, d, **kwargs):
    mesh = jmesh(d, ("x",), platform="cpu")
    inv, ok = jsh.sharded_blocked_inverse(jnp.asarray(a), mesh=mesh,
                                          **kwargs)
    return np.asarray(inv.astype(jnp.float32) if inv.dtype == jnp.bfloat16
                      else inv), bool(ok)


def _jax_batched(a, shape, **kwargs):
    mesh = jmesh(shape, ("dp", "tp"), platform="cpu")
    inv, ok = jsh.sharded_batched_inverse(jnp.asarray(a), mesh=mesh,
                                          **kwargs)
    return np.asarray(inv.astype(jnp.float32) if inv.dtype == jnp.bfloat16
                      else inv), np.asarray(ok)


@pytest.mark.parametrize("case,a,d,kwargs", [
    ("inv256", A256, 8, dict(block_size=32)),
    ("inv320", A320, 8, dict(block_size=16, group_size=4)),
    ("inv200", A200, 4, dict(block_size=32)),
])
def test_sharded_inverse_matches_jax(world, case, a, d, kwargs):
    """tests/test_sharded.py's 256 on d = 8, 320 on d = 8 with b = 16 and
    group 4 (groups straddle the 96-wide shards), and 200 (padded) on
    d = 4."""
    inv, ok = _replicated(world(d)[case])
    want, ok_j = _jax_inverse(a, d, **kwargs)
    assert bool(ok) and ok_j and inv.shape == a.shape
    assert _rel(inv.numpy(), want) <= TOL
    assert relative_residual(a, inv.numpy()) < 1e-5


def test_sharded_ok_matches_jax_on_singular_and_nonfinite(world):
    """The all-ones 64^2 (b = 16, d = 4) and the 256^2 with one inf (d = 8):
    ok false in both packages."""
    _, ok_ones = _replicated(world(4)["ones64"])
    _, ok_j = _jax_inverse(ONES, 4, block_size=16)
    assert not bool(ok_ones) and not ok_j
    _, ok_inf = _replicated(world(8)["nonfinite"])
    _, ok_j = _jax_inverse(NONFINITE, 8, block_size=32)
    assert bool(ok_inf) == ok_j and not ok_j


@pytest.mark.parametrize("case,a,kwargs", [
    ("batched64", BATCH64, dict(block_size=16)),
    ("batched768", BATCH768, dict(block_size=128, group_size=3)),
])
def test_sharded_batched_matches_jax(world, case, a, kwargs):
    """The (2, 4) dp x tp mesh: n = 64 at b = 16, and n = 768 at b = 128
    with group 3 (gw = 384 straddles the 512-wide tp shards); raw, as the
    reference's batched route.

    The 768^2 pair has kappa up to 2.5e5, so a raw fp32 inverse carries
    rounding of order kappa * 2^-24 ~ 1.5e-2 of max|inv|, and two correct
    implementations part by that much: the reference and the port differ
    by 2.9e-3, and by 4.0e-3 with the port's GEMMs in FP32 too
    (``precision="high"``, another summation order). So that case is held
    to the reference's own forward error against the float64 inverse
    (port 8.7e-4, reference 2.0e-3), not to 1e-4 of it."""
    inv, ok = _replicated(world(8)[case])
    want, ok_j = _jax_batched(a, (2, 4), **kwargs)
    assert inv.shape == a.shape and bool(ok.all()) and ok_j.all()
    if case == "batched64":
        assert _rel(inv.numpy(), want) <= TOL
    else:
        exact = np.linalg.inv(a.astype(np.float64))
        assert _rel(inv.numpy(), exact) <= _rel(want, exact)
    for i in range(a.shape[0]):
        assert relative_residual(a[i], inv[i].numpy()) < 1e-4


def test_sharded_bf16_io_matches_jax(world):
    """bf16 in, fp32 compute, bf16 out: 96^2 on d = 4 and a pair on a
    (2, 2) mesh."""
    inv, ok = _replicated(world(4)["bf16"])
    a = np.asarray(_bf16(A96).float())
    want, ok_j = _jax_inverse(jnp.asarray(A96, dtype=jnp.bfloat16), 4,
                              block_size=16)
    assert inv.dtype == torch.bfloat16 and bool(ok) and ok_j
    assert _rel(inv.float().numpy(), want) <= TOL_BF16
    assert relative_residual(a, inv.float().numpy()) < 1e-2
    invb, okb = _replicated(world(4)["bf16_batched"])
    wantb, okb_j = _jax_batched(
        jnp.asarray(np.stack([A96, A96B]), dtype=jnp.bfloat16), (2, 2),
        block_size=16)
    assert invb.dtype == torch.bfloat16 and bool(okb.all()) and okb_j.all()
    assert _rel(invb.float().numpy(), wantb) <= TOL_BF16


def test_sharded_fp64_matches_jax(world):
    inv, ok = _replicated(world(4)["fp64"])
    want, ok_j = _jax_inverse(A128_64, 4, block_size=16)
    assert inv.dtype == torch.float64 and bool(ok) and ok_j
    assert _rel(inv.numpy(), want) <= TOL64
    assert relative_residual(A128_64, inv.numpy()) < 1e-14


def test_sharded_solve_matches_jax(world):
    x, ok = _replicated(world(4)["solve"])
    mesh = jmesh(4, ("x",), platform="cpu")
    want, ok_j = jsolver.solve(jnp.asarray(A_SOLVE), jnp.asarray(RHS),
                               method="sharded", mesh=mesh)
    assert bool(ok) and bool(ok_j)
    assert _rel(x.numpy(), np.asarray(want)) <= TOL
    r = np.linalg.norm(A_SOLVE.astype(np.float64) @ x.numpy() - RHS)
    assert r / np.linalg.norm(RHS) < 1e-4


def test_sharded_refine_polish(world):
    inv0, _ = _replicated(world(4)["refine0"])
    inv1, ok = _replicated(world(4)["refine1"])
    assert bool(ok)
    assert (relative_residual(A192, inv1.numpy())
            <= relative_residual(A192, inv0.numpy()))


def test_pivot_order_same_on_every_world_size(world):
    """256^2 at b = 32 on 1, 2, 4 and 8 ranks: the same pivot order
    (group widths differ with d: gw = 256, 256, 128, 64)."""
    pos = [_replicated(world(d)["raw256"])[2] for d in (1, 2, 4, 8)]
    for other in pos[1:]:
        assert torch.equal(other, pos[0])


def test_one_rank_is_the_blocked_driver_bit_for_bit(world):
    """At d = 1 every operation is the blocked route's own (the plain
    logical panel on a CPU mesh), so the raw result is bit for bit
    ``_blocked_gj`` at the same group size (tests/test_sharded.py:117-134).
    """
    inv, ok, _ = _replicated(world(1)["raw256"])
    b, _, group, _, _ = tsh._sharded_params(256, 32, 1, torch.float32,
                                            False, None)
    want, ok_b = tblocked._blocked_gj(
        torch.from_numpy(A256), pivot=True, b=b, group_size=group,
        precision="highest", use_kernels=False, search_bf16=False)
    assert bool(ok) and bool(ok_b)
    assert torch.equal(inv, want)


@pytest.mark.parametrize("d,case,n,kwargs", [
    (1, "raw256", 256, dict(block_size=32)),
    (2, "raw256", 256, dict(block_size=32)),
    (4, "raw256", 256, dict(block_size=32)),
    (8, "raw256", 256, dict(block_size=32)),
    (8, "inv320", 320, dict(block_size=16, group_size=4)),
    (4, "inv200", 200, dict(block_size=32)),
])
def test_one_collective_per_group(world, d, case, n, kwargs):
    """Every rank runs one collective per panel group, then the slot
    gather (a broadcast from each rank that holds slot columns) and the ok
    reduction; the Newton-Schulz polish runs none."""
    b, m, group, _, _ = tsh._sharded_params(
        n, kwargs["block_size"], d, torch.float32, False,
        kwargs.get("group_size"))
    groups = len(tblocked._group_sizes(m, b, group))
    assert [r["collectives"] for r in world(d)[case]] == (
        [groups + _slot_holders(m, d) + 1] * d)


def _slot_holders(m: int, d: int) -> int:
    """Ranks of a d-wide axis that hold slot columns [m, 2m): the upper
    half for an even d, the one rank at d = 1."""
    w = 2 * m // d
    holders = sum(lo < hi for lo, hi in (tsh._overlap(m, m, r, w)
                                         for r in range(d)))
    assert holders == max(1, d // 2)
    return holders


def test_batched_collectives_and_window_skip(world):
    """(2, 4) at n = 768, group 3: each rank inverts its dp slice over its
    tp group (per matrix a collective a group, the gather, the ok
    reduction), then the two dp gathers. And the window skip: at d = 8
    (256^2, 4 groups) the edge ranks' columns never meet the live window,
    so they run fewer update GEMMs than there are groups."""
    b, m, group, _, _ = tsh._sharded_params(768, 128, 4, torch.float32,
                                            False, 3)
    groups = len(tblocked._group_sizes(m, b, group))
    per_rank = BATCH768.shape[0] // 2
    assert [r["collectives"] for r in world(8)["batched768"]] == (
        [per_rank * (groups + _slot_holders(m, 4) + 1) + 2] * 8)
    b, m, group, _, _ = tsh._sharded_params(256, 32, 8, torch.float32,
                                            False, None)
    groups = len(tblocked._group_sizes(m, b, group))
    updates = [r["updates"] for r in world(8)["raw256"]]
    assert min(updates) < groups and max(updates) <= groups
    assert updates[0] == 0 and updates[-1] == 0


@pytest.mark.parametrize("n,d", [(8100, 3), (16350, 3), (8100, 8),
                                 (4096, 6), (513, 3), (4096, 4), (768, 4)])
@pytest.mark.parametrize("group_size", [None, 3])
def test_sharded_params_equal_jax(n, d, group_size):
    got = tsh._sharded_params(n, 128, d, torch.float32, False, group_size)
    want = jsh._sharded_params(n, 128, d, jnp.float32, False, group_size)
    assert got == tuple(want)
    b, m, _, _, _ = got
    assert m % (b * d) == 0 and m >= n


def test_batched_fused_route_gate():
    """A dp-only cuda mesh with n <= FUSED_MAX_N in fp32 or bf16 takes K1;
    anything else the column-sharded body (tests/test_sharded.py's cases,
    ``cuda_mesh`` for the reference's ``tpu_mesh``)."""
    gate = tsh._batched_fused_route
    assert gate(1, 128, torch.float32, True)
    assert gate(1, 640, torch.bfloat16, True)
    assert not gate(2, 128, torch.float32, True)
    assert not gate(1, 641, torch.float32, True)
    assert not gate(1, 128, torch.float32, False)
    assert not gate(1, 128, torch.float64, True)
    for args in ((1, 128, True), (2, 128, True), (1, 641, True),
                 (1, 128, False)):
        assert gate(args[0], args[1], torch.float32, args[2]) == (
            jsh._batched_fused_route(args[0], args[1], jnp.float32,
                                     args[2]))


def test_auto_routes_32768_to_sharded_with_a_mesh():
    """``auto`` sends a single matrix from n = 32768 to ``sharded`` when a
    mesh is passed, as the reference does; without a mesh or a world of
    more than one rank, to ``blocked``."""
    a = torch.empty((32768, 32768), device="meta")
    ja = jax.ShapeDtypeStruct((32768, 32768), jnp.float32)
    mesh = object()
    assert tsolver._resolve("auto", a, mesh) == "sharded"
    assert tsolver._resolve("auto", a) == "blocked"
    assert jsolver._resolve("auto", ja, mesh) == "sharded"
    small = torch.empty((32767, 32767), device="meta")
    assert tsolver._resolve("auto", small, mesh) == "blocked"
    batch = torch.empty((2, 32768, 32768), device="meta")
    assert tsolver._resolve("auto", batch, mesh) == "blocked"
    assert tsolver.SHARDED_AUTO_MIN_N == jsolver.SHARDED_AUTO_MIN_N


def test_auto_routes_to_a_world_only_on_a_device_it_serves(world):
    """With no mesh, ``auto`` takes a world of more than one rank only for
    input on a device its backend serves: on 2 gloo ranks a 32768^2 CPU
    tensor goes to ``sharded``, a tensor on another device (meta here, a
    card tensor alike) to ``blocked``."""
    assert [r["out"] for r in world(2)["route_cpu"]] == ["sharded"] * 2
    assert [r["out"] for r in world(2)["route_meta"]] == ["blocked"] * 2


def test_input_device_must_match_the_mesh():
    """The route never moves its input to another device: under a gloo
    world, input on another device (meta here, a card tensor alike) raises
    ValueError with no mesh (the backend does not serve it) and with a cpu
    mesh (``inverse`` and ``solve`` too); CPU input with no mesh runs on a
    cpu mesh over the world, as with one passed."""
    meta = torch.empty((64, 64), device="meta")
    a = torch.from_numpy(A200)
    with launch.world("gloo"):
        assert tmesh.world_serves("cpu") and not tmesh.world_serves("cuda")
        with pytest.raises(ValueError, match="does not serve"):
            tsh.sharded_blocked_inverse(meta)
        with pytest.raises(ValueError, match="does not serve"):
            tsh.sharded_batched_inverse(meta[None])
        mesh = tmesh.make_device_mesh(1, ("x",), platform="cpu")
        with pytest.raises(ValueError, match="mesh"):
            tsolver.inverse(meta, method="sharded", mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            tsolver.solve(meta, torch.ones(64, device="meta"),
                          method="sharded", mesh=mesh)
        inv, ok = tsh.sharded_blocked_inverse(a, block_size=32)
        want, _ = tsh.sharded_blocked_inverse(a, mesh=mesh, block_size=32)
        assert bool(ok) and inv.device == a.device and torch.equal(inv, want)
    assert not tmesh.world_serves("cpu")


def test_mesh_needs_a_world():
    """No process group: making a mesh raises ValueError naming what to
    initialize; it never falls back to one device."""
    assert tmesh.world_size() == 0
    with pytest.raises(ValueError, match="init_process_group"):
        tmesh.make_device_mesh(1, ("x",), platform="cpu")
    with pytest.raises(ValueError, match="axis"):
        tmesh.make_device_mesh((2, 2), ("x",), platform="cpu")


def test_spawn_ranks_reports_a_failing_rank():
    """A rank that raises fails the call with its traceback: here a mesh
    of 3 on a world of 2."""
    call = (tsh.sharded_blocked_inverse, (3,), ("x",), (A200,), {})
    with pytest.raises(RuntimeError, match="world has 2"):
        launch.spawn_ranks(2, launch.run_calls, [call], timeout=120)


def test_dryrun_multichip():
    """The port of ``__graft_entry__.dryrun_multichip(8)`` on 8 gloo ranks:
    2048^2 on a 1-D mesh at the default geometry, then the (2, 4) batch at
    b = 128, group 3."""
    launch.dryrun_multichip(8)
