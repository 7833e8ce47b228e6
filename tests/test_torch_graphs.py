"""The compiled routes' graph cache (``utils/graphs.py``) on the CPU: the
key, the gate, the process state a graph would bake in, ``disabled()``,
and ``enable_compile_cache`` against the JAX package's, and that no
compiled body reads a value back to the host. Graphs exist only
on CUDA; the on-card checks are in ``tests/test_torch_cuda.py``."""

import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu.utils import config as jconfig  # noqa: E402
import gpu_matrix_inversion_tpu_torch as tpkg  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models import newton_schulz  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import (blocked, cholesky,  # noqa: E402,E501
                                                gauss_jordan, lockstep, lu,
                                                refine)
from gpu_matrix_inversion_tpu_torch.utils import (config, cuda_build,  # noqa: E402,E501
                                                  determinism, graphs,
                                                  profiling)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "gpu_matrix_inversion_tpu_torch"

# The port's counterparts of the JAX package's jit sites.
COMPILED = [blocked.blocked_inverse, lockstep.lockstep_inverse,
            lu.lu_factor_blocked, lu.lu_solve_fast, lu.lu_inverse_fast,
            lu.invert_triangular, cholesky.cholesky_factor,
            cholesky.cholesky_solve, cholesky.cholesky_inverse,
            refine.newton_schulz_refine, refine.refine_solve,
            newton_schulz.newton_schulz_inverse,
            gauss_jordan.gauss_jordan_inverse]


def _sig(shape=(4, 4), dtype=torch.float32, **static):
    return graphs.signature("f", {"a": torch.zeros(shape, dtype=dtype)},
                            static)


@pytest.mark.parametrize("fn", COMPILED, ids=[fn.__name__ for fn in COMPILED])
def test_jit_sites_are_compiled(fn):
    """Each counterpart of a jit site goes through the graph cache and
    keeps its own signature; the defaults of its arguments that are not
    tensors, static in the key, are hashable."""
    assert hasattr(fn, "__wrapped__")
    params = inspect.signature(fn).parameters
    assert list(params) == list(inspect.signature(fn.__wrapped__).parameters)
    for param in params.values():
        if param.default is not param.empty:
            hash(param.default)


def test_same_call_same_key():
    assert _sig(pivot=True) == _sig(pivot=True)
    assert hash(_sig(pivot=True)) == hash(_sig(pivot=True))


@pytest.mark.parametrize("other", [
    lambda: _sig((5, 5), pivot=True),
    lambda: _sig((2, 4, 4), pivot=True),
    lambda: _sig(dtype=torch.float64, pivot=True),
    lambda: _sig(pivot=False),
    lambda: graphs.signature("g", {"a": torch.zeros(4, 4)},
                             {"pivot": True}),
    lambda: graphs.signature("f", {"a": torch.zeros(4, 4).t()[:, :4]
                                   .contiguous().t()}, {"pivot": True}),
], ids=["shape", "batch", "dtype", "static", "function", "strides"])
def test_key_differs(other):
    assert other() != _sig(pivot=True)


@pytest.mark.parametrize("name", graphs.KEY_ENV)
def test_key_holds_each_environment_variable(name, monkeypatch):
    monkeypatch.delenv(name, raising=False)
    before = _sig()
    monkeypatch.setenv(name, "1")
    assert _sig() != before


@pytest.mark.parametrize("module,name", graphs.KEY_SWITCHES)
def test_key_holds_each_module_switch(module, name, monkeypatch):
    mod = __import__(f"gpu_matrix_inversion_tpu_torch.{module}",
                     fromlist=[name])
    before = _sig()
    value = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        (not value) if isinstance(value, bool) else value - 1)
    assert _sig() != before


@pytest.mark.parametrize("flag", ["tf32", "cudnn_tf32", "bf16_reduction"])
def test_key_holds_torch_matmul_switches(flag):
    matmul = torch.backends.cuda.matmul
    before = _sig()
    if flag == "tf32":
        prev = matmul.allow_tf32
        matmul.allow_tf32 = not prev
        try:
            assert _sig() != before
        finally:
            matmul.allow_tf32 = prev
    elif flag == "cudnn_tf32":
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = not prev
        try:
            assert _sig() != before
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    else:
        prev = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = not prev
        try:
            assert _sig() != before
        finally:
            matmul.allow_bf16_reduced_precision_reduction = prev
    assert _sig() == before


def _route_sources():
    """ops/, models/ and the modules of utils/ they import."""
    bodies = (sorted((PKG / "ops").glob("*.py"))
              + sorted((PKG / "models").glob("*.py")))
    helpers = set()
    for path in bodies:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith(f"{PKG.name}.utils")):
                helpers.update(
                    [a.name for a in node.names]
                    if node.module == f"{PKG.name}.utils"
                    else [node.module.rsplit(".", 1)[1]])
    # The cache itself, and the solver's settings: what config reads from
    # the environment reaches a route as its arguments, static in the key.
    helpers -= {"graphs", "config"}
    assert {"profiling", "cuda_build", "precision"} <= helpers
    return bodies + [PKG / "utils" / f"{name}.py" for name in sorted(helpers)]


# Environment variables a helper reads that no graph bakes in: where nvcc
# is, read once a process when the kernel library is built.
NOT_BAKED = {"CUDA_HOME"}


def _env_reads(tree):
    """(name, inside a function, module-level target or None) of every
    os.environ.get("NAME") and os.environ["NAME"] in ``tree``."""
    out = []

    def env_name(node):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ"):
            return ast.literal_eval(node.args[0])
        if (isinstance(node, ast.Subscript)
                and ast.unparse(node.value) == "os.environ"):
            return ast.literal_eval(node.slice)
        return None

    for top in tree.body:
        target = None
        if isinstance(top, ast.Assign) and len(top.targets) == 1:
            target = ast.unparse(top.targets[0])
        inside = isinstance(top, (ast.FunctionDef, ast.ClassDef))
        for node in ast.walk(top):
            name = env_name(node)
            if name is not None:
                out.append((name, inside, None if inside else target))
    return out


def _reassigned_names() -> set:
    """Module-level names that code changes at run time: attribute
    assignments (``mod.NAME = ...``), ``setattr(mod, "NAME", ...)`` and
    ``global NAME`` in the scripts, probes, port tests and the package."""
    files = ([REPO / "chip_smoke.py"] + sorted((REPO / "probes").glob("*.py"))
             + sorted((REPO / "tests").glob("test_torch_*.py"))
             + sorted(PKG.rglob("*.py")))
    names = set()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        names.add(tgt.attr)
            elif (isinstance(node, ast.Call)
                  and ast.unparse(node.func).endswith("setattr")
                  and len(node.args) >= 2
                  and isinstance(node.args[1], ast.Constant)):
                names.add(node.args[1].value)
            elif isinstance(node, ast.Global):
                names.update(node.names)
    return names


def test_key_lists_every_switch_a_compiled_body_reads():
    """Scan ops/, models/ and utils/: every environment variable a
    function reads
    at call time is in KEY_ENV, every module-level value read from the
    environment at import is in KEY_SWITCHES, and so is every module-level
    scalar that some code changes at run time. A new switch cannot be
    baked into a graph unseen."""
    switches = set(graphs.KEY_SWITCHES)
    reassigned = _reassigned_names()
    found_env, found_switch = set(), set()
    for path in _route_sources():
        module = f"{path.parent.name}.{path.stem}"
        tree = ast.parse(path.read_text())
        for name, inside, target in _env_reads(tree):
            if name in NOT_BAKED:
                continue
            if inside:
                found_env.add(name)
                assert name in graphs.KEY_ENV, f"{path.name} reads {name}"
            else:
                found_switch.add((module, target))
                assert (module, target) in switches, (
                    f"{path.name}: {target} is read from {name} at import")
        mod = __import__(f"gpu_matrix_inversion_tpu_torch.{module}",
                         fromlist=["_"])
        for top in tree.body:
            if isinstance(top, ast.Assign):
                for tgt in top.targets:
                    if (isinstance(tgt, ast.Name) and tgt.id in reassigned
                            and isinstance(getattr(mod, tgt.id, None),
                                           (bool, int, float, str))):
                        found_switch.add((module, tgt.id))
                        assert (module, tgt.id) in switches, (
                            f"{module}.{tgt.id} is changed at run time")
    assert found_env == set(graphs.KEY_ENV)
    assert found_switch == switches


def test_counted_wrappers_cover_every_launch_counter():
    """Every kernel wrapper in ops/ counts where it launches its kernel,
    once, and only outside a capture: a kernel recorded into a graph is
    no launch, and nothing else adds to a count."""
    wrappers = 0
    for path in sorted((PKG / "ops").glob("*.py")):
        text = path.read_text()
        for name in re.findall(r"^(\w+)\.launches = 0$", text, re.M):
            wrappers += 1
            adds = re.findall(rf"^( *)(.*)\n *{name}\.launches \+=", text,
                              re.M)
            assert [line for _, line in adds] == [
                "if not cuda_build.capturing():   # a graph's record is no "
                "launch"], name
    assert wrappers == 9
    for path in [REPO / "chip_smoke.py"] + sorted(PKG.rglob("*.py")):
        assert not re.search(r"\.launches \+= (?!1\b)", path.read_text()), (
            path)


def _cuda_sig(*shapes, devices=None):
    devices = devices or ["cuda:0"] * len(shapes)
    return graphs.Signature("f", tuple(
        (f"t{i}", shape, (), torch.float32, dev)
        for i, (shape, dev) in enumerate(zip(shapes, devices))), (), ())


@pytest.mark.parametrize("shapes,devices,want", [
    ([(4096, 4096)], None, True),
    ([(8192, 8192)], None, True),
    ([(8193, 8193)], None, False),
    ([(20000, 20000)], None, False),
    ([(16, 1024, 1024)], None, True),
    ([(8, 2048, 2048)], None, True),
    ([(64, 1024, 1024)], None, True),
    ([(65, 1024, 1024)], None, False),
    ([(4096, 4096), (4096,), (4096, 16)], None, True),
    ([(4096, 4096)], ["cpu"], False),
    ([(64, 64), (64, 64)], ["cpu", "cuda:0"], False),
    ([(64, 64), (64, 64)], ["cuda:0", "cuda:1"], False),
])
def test_gate(shapes, devices, want):
    """One matrix to 8192^2, a batch to batch * n^2 = 8192^2, on one CUDA
    device; a pure function of the signature."""
    assert graphs.captures(_cuda_sig(*shapes, devices=devices)) is want


def test_cpu_tensors_never_enter_the_cache():
    """The CPU path is eager: each compiled route on CPU tensors leaves the
    cache and stats() empty."""
    graphs.clear()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 64)) + 64 * np.eye(64))
    a32 = a.float()
    spd = a @ a.T / 64 + torch.eye(64, dtype=a.dtype)
    rhs = torch.from_numpy(rng.standard_normal((64, 2)))
    tpkg.inverse(a32, method="blocked")
    tpkg.inverse(a32, method="lu")
    tpkg.inverse(spd, method="cholesky")
    tpkg.inverse(spd, method="ns")
    tpkg.inverse(a, method="spec")
    tpkg.solve(a32, rhs.float(), method="lu")
    tpkg.solve(spd, rhs, method="cholesky", refine_iters=1)
    assert graphs.stats() == {}
    assert graphs._cache.entries == {} and graphs._cache.pools == {}


def test_compiled_checks_its_arguments():
    """Every argument that is not a tensor is static, so it must hash."""
    @graphs.compiled
    def scale(x, *, k):
        return x * k

    x = torch.ones(3)
    assert torch.equal(scale(x, k=2), 2 * x)
    with pytest.raises(TypeError, match="'k' is neither a tensor nor "
                                        "hashable"):
        scale(x, k=[2])
    with pytest.raises(TypeError, match="'x' is neither a tensor nor "
                                        "hashable"):
        scale([1.0, 2.0], k=2)


def test_signature_names_the_call():
    text = str(graphs.signature("blocked_inverse",
                                {"a": torch.zeros(8, 8)}, {"refine": 1}))
    assert text == "blocked_inverse(a: (8, 8) float32 cpu, refine=1)"


def test_disabled_nests_and_restores():
    assert not graphs._flag("disabled")
    with graphs.disabled():
        assert graphs._flag("disabled")
        with graphs.disabled():
            assert graphs._flag("disabled")
        assert graphs._flag("disabled")
    assert not graphs._flag("disabled")
    with pytest.raises(ValueError):
        with graphs.disabled():
            raise ValueError
    assert not graphs._flag("disabled")


def test_phase_ranges_run_compiled_calls_eagerly(tmp_path):
    """trace() and phase_ranges() run the compiled routes eagerly, so the
    blocked driver's phase ranges hold their kernels; and the switch is in
    the key besides."""
    assert ("utils.profiling", "_ranges_on") in graphs.KEY_SWITCHES
    with profiling.phase_ranges():
        assert graphs._flag("disabled") and profiling._ranges_on
    assert not graphs._flag("disabled") and not profiling._ranges_on
    with profiling.trace(str(tmp_path), device="cpu"):
        assert graphs._flag("disabled")
    assert not graphs._flag("disabled")


def test_check_deterministic_runs_eagerly_first():
    """check_deterministic's first run is eager (graphs.disabled()), the
    rest reach the graph cache."""
    seen = []

    def fn():
        seen.append(graphs._flag("disabled"))
        return torch.ones(2)

    assert determinism.check_deterministic(fn, runs=3)[0]
    assert seen == [True, False, False]


def test_enable_compile_cache_disabled_as_in_jax(monkeypatch):
    """MATINV_COMPILE_CACHE=0: both packages return None, and the kernel
    library stays where it was."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    before = cuda_build.library_path()
    for value in ("0", "false", "off"):
        monkeypatch.setenv("MATINV_COMPILE_CACHE", value)
        assert jconfig.enable_compile_cache() is None
        assert config.enable_compile_cache() is None
        assert config.enable_compile_cache("/elsewhere") is None
    assert cuda_build.library_path() == before


def test_enable_compile_cache_moves_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("MATINV_COMPILE_CACHE", raising=False)
    name = cuda_build.library_path().name
    assert config.enable_compile_cache(str(tmp_path)) == str(tmp_path)
    assert cuda_build.library_path() == tmp_path / name
    monkeypatch.setenv("MATINV_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert config.enable_compile_cache() == str(tmp_path / "env")
    assert cuda_build.library_path() == tmp_path / "env" / name


class _NoHostReads(TorchDispatchMode):
    """Fails on any read of a tensor's value back to the host
    (``aten._local_scalar_dense``: ``.item()``, ``bool(t)``, and indexing
    with a 0-dim tensor), which a CUDA graph cannot capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func is not torch.ops.aten._local_scalar_dense.default, (
            "a compiled body read a value back to the host")
        return func(*args, **(kwargs or {}))


def _host_read_free_calls():
    """Compiled bodies on the CPU that reach no kernel twin (the twins may
    read values back; on the card the kernels run instead)."""
    rng = np.random.default_rng(3)
    n = 48
    h = rng.standard_normal((n, n))
    dom = torch.from_numpy(h + 2 * np.abs(h).sum(axis=1).max() * np.eye(n))
    spd = torch.from_numpy(h @ h.T / n + np.eye(n))
    rhs = torch.from_numpy(rng.standard_normal((n, 3)))
    lu_, perm, _ = lu.lu_factor_blocked(dom, block_size=16)
    return {
        "no-pivot FP64 blocked (logical panel)":
            lambda: blocked.blocked_inverse(dom, pivot=False, block_size=16),
        "FP64 getrf (plain panel)":
            lambda: lu.lu_factor_blocked(dom, block_size=16),
        "spec": lambda: gauss_jordan.gauss_jordan_inverse(dom),
        "potri": lambda: cholesky.cholesky_inverse(spd),
        "potrs": lambda: cholesky.cholesky_solve(
            cholesky.cholesky_factor(spd)[0], rhs),
        "getrs": lambda: lu.lu_solve_fast(lu_, perm, rhs),
        "trtri": lambda: lu.invert_triangular(dom, lower=True, b=16),
        "Newton-Schulz": lambda: newton_schulz.newton_schulz_inverse(spd),
        "refine_solve": lambda: refine.refine_solve(dom, rhs, rhs, lu_,
                                                    perm, iters=1),
    }


@pytest.mark.parametrize("route", [
    "no-pivot FP64 blocked (logical panel)", "FP64 getrf (plain panel)",
    "spec", "potri", "potrs", "getrs", "trtri", "Newton-Schulz",
    "refine_solve"])
def test_route_bodies_read_nothing_back(route):
    """No compiled body reads a value back to the host: a graph could not
    capture it (the logical panels indexed by a 0-dim pivot tensor did,
    once a pivot step)."""
    call = _host_read_free_calls()[route]
    with _NoHostReads():
        call()
