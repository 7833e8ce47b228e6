"""Compiled routes: one CUDA graph per static signature, captured once and
replayed.

The JAX package runs each route as one program per static signature: its
``jit`` sites (``functools.partial(jax.jit, static_argnames=...)``) trace
the Python body once, compile it, and keep the program for the process.
This module stands for that cache; it has no module counterpart in the JAX
package. :func:`compiled` goes on the port's counterparts of the ``jit``
sites; every argument that is not a tensor is static. On a CUDA tensor
inside :func:`captures`' gate, the first call with a signature

1. runs the body once eagerly on a side stream (the warm-up: it builds the
   kernels and fills ``cluster_plan``'s occupancy queries and like caches);
2. captures the body into a ``torch.cuda.CUDAGraph`` whose memory comes
   from one pool that every cached graph shares (graphs replay one at a
   time, on one stream, so their scratch may overlap), keeping the
   graph's static input and output tensors alive in the cache;
3. replays it, as every later call does: the inputs are copied into the
   static buffers, the graph replays on the current stream, and the
   outputs come back as fresh clones, so that a later replay never
   overwrites a result the caller still holds.

The cache keeps the :data:`MAX_GRAPHS` graphs used last; the next capture
drops the one used least recently (its blocks go back to the pool, which
keeps them for later captures).

A capture that fails raises :class:`GraphCaptureError` naming the function
and the signature, and empties the cache; nothing drops to eager on the
quiet. A body that syncs the host (``.item()``, ``bool(tensor)``, a copy
from host memory) fails its capture, and the body is at fault. CPU tensors
run the body eagerly: that is the port's CPU path, and graphs exist only
on CUDA. A call under :func:`disabled` (the counterpart of
``jax.disable_jit()``) runs eagerly, and so does a call past the gate. A
compiled call nested in another follows the outer one: inside a warm-up,
a capture or an eager call past the gate it runs inline, as a ``jit``
inside a ``jit`` is traced into the outer program.

A graph bakes in every value its body reads from the process at capture
time, so the key holds them: :data:`KEY_ENV`, :data:`KEY_SWITCHES` and
PyTorch's matmul and linalg switches (:func:`process_state`).

Kernel launch counts (each wrapper's ``launches``) count launches from the
host: the eager calls and the warm-ups. A kernel recorded into a graph is
not counted, and a replay runs no wrapper, so it adds nothing. What a
replay launches is read from the graph itself (:func:`kernel_nodes`) and
what it ran from the profiler's kernel records
(``utils/profiling.device_kernels``). :func:`stats` gives the captures
and replays of each function, :func:`first_calls` what each first call
spent. While a profiler session records, a call on a CUDA tensor outside
a capture opens the ranges ``graphs.key`` (its signature and the gate),
then, served from the cache, ``graphs.copy_in`` (a replay's input
copies), ``graphs.replay`` and ``graphs.copy_out`` (the outputs' clones)
(``utils/profiling.span``).

The in-memory cache is the whole of it: a CUDA graph cannot outlive its
process, so nothing persists across processes (``utils/config.
enable_compile_cache`` keeps the kernel library's build instead).
"""


from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import importlib
import inspect
import os
import threading
import time

import torch

from gpu_matrix_inversion_tpu_torch.utils.profiling import span

_PACKAGE = "gpu_matrix_inversion_tpu_torch"

# The environment variables the compiled bodies read at call time.
KEY_ENV = ("MATINV_GETRI_ROUTE",   # ops/lu.lu_inverse_fast
           "MATINV_LU_GROUP",      # ops/lu.lu_factor_blocked
           "MATINV_LOCKSTEP")      # ops/lockstep._lockstep_k
# Module-level values the bodies read that code changes at run time: the
# potri product schedule (read from MATINV_POTRI_PRODUCT at import), the
# cluster caps of the panel kernels (K2, K3, K6) and of K1, and whether
# the blocked driver opens profiler ranges (profiling.phase_ranges runs
# compiled calls eagerly besides: a replay opens no range).
KEY_SWITCHES = (("ops.cholesky", "_POTRI_PRODUCT_2D"),
                ("ops.blocked", "MAX_CLUSTER"),
                ("ops.fused", "MAX_CLUSTER"),
                ("ops.fused", "GROW_CLUSTER"),
                ("utils.profiling", "_ranges_on"))

# The gate: one matrix up to 8192^2, a batch up to batch * n^2 = 8192^2
# elements, in the largest tensor argument. Past it the device is busy for
# nearly all of an eager call (split 20000^2 idles 6.0% of it, 32768^2
# 1.6%; H100 80GB HBM3, 700 W) and a graph would hold gigabytes in the pool.
GATE_ELEMENTS = 8192 * 8192
# The graphs the cache keeps, the ones used last.
MAX_GRAPHS = 64


class GraphCaptureError(RuntimeError):
    """Capturing a compiled function's body into a CUDA graph failed."""


def _attr(module: str, name: str):
    return getattr(importlib.import_module(f"{_PACKAGE}.{module}"), name)


def process_state() -> tuple:
    """The process state a compiled body reads at call time, in the order
    :data:`KEY_ENV`, :data:`KEY_SWITCHES`, then PyTorch's switches: TF32
    for matmuls and cuDNN, the reduced-precision bf16 and fp16 reductions,
    the float32 matmul precision and the preferred linalg library."""
    matmul = torch.backends.cuda.matmul
    return (tuple(os.environ.get(name) for name in KEY_ENV)
            + tuple(_attr(mod, name) for mod, name in KEY_SWITCHES)
            + (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
               matmul.allow_bf16_reduced_precision_reduction,
               matmul.allow_fp16_reduced_precision_reduction,
               torch.get_float32_matmul_precision(),
               str(torch.backends.cuda.preferred_linalg_library())))


@dataclasses.dataclass(frozen=True)
class Signature:
    """What a graph is captured for: the function, each tensor argument's
    (name, shape, strides, dtype, device), the static arguments and the
    :func:`process_state`. Equal signatures share one graph."""
    fn: str
    tensors: tuple
    static: tuple
    state: tuple

    def __str__(self) -> str:
        args = [f"{name}: {tuple(shape)} {str(dtype).split('.')[-1]} "
                f"{dev}" for name, shape, _, dtype, dev in self.tensors]
        args += [f"{name}={value!r}" for name, value in self.static]
        return f"{self.fn}({', '.join(args)})"


def signature(fn: str, tensors: dict, static: dict) -> Signature:
    """The :class:`Signature` of a call of ``fn`` with ``tensors`` (name ->
    tensor) and ``static`` (name -> hashable value)."""
    return Signature(
        fn, tuple((name, tuple(t.shape), t.stride(), t.dtype, str(t.device))
                  for name, t in tensors.items()),
        tuple(static.items()), process_state())


def captures(sig: Signature) -> bool:
    """The gate, a pure function of the signature: every tensor argument
    on one CUDA device, and none larger than :data:`GATE_ELEMENTS`."""
    devices = {dev for _, _, _, _, dev in sig.tensors}
    if len(devices) != 1 or not devices.pop().startswith("cuda"):
        return False
    largest = 0
    for _, shape, _, _, _ in sig.tensors:
        size = 1
        for dim in shape:
            size *= dim
        largest = max(largest, size)
    return largest <= GATE_ELEMENTS


_state = threading.local()


def _flag(name: str) -> bool:
    return getattr(_state, name, False)


@contextlib.contextmanager
def _set(name: str):
    prev = _flag(name)
    setattr(_state, name, True)
    try:
        yield
    finally:
        setattr(_state, name, prev)


def disabled():
    """Run compiled functions eagerly in the enclosed block (this thread),
    as ``jax.disable_jit()`` does; nests, and restores on exit."""
    return _set("disabled")


def _flatten(out, leaves: list):
    """The tensors of ``out`` (a tensor or nested tuples of tensors) into
    ``leaves``; returns the structure :func:`_unflatten` rebuilds."""
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return None
    if isinstance(out, tuple):
        return tuple(_flatten(x, leaves) for x in out)
    raise TypeError(f"a compiled function returns tensors or tuples of "
                    f"them, not {type(out).__name__}")


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    return tuple(_unflatten(s, leaves) for s in spec)


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: dict        # name -> static input tensor
    outputs: list       # static output tensors
    spec: object        # the output structure


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


class _Cache:
    """The process's graphs, keyed by :class:`Signature` and kept in the
    order of their last use, with one memory pool and one capture stream
    a device."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        self.pools = {}
        self.streams = {}
        self.counts = {}
        self.firsts = {}

    def _count(self, fn: str, what: str) -> None:
        self.counts.setdefault(fn, {"captures": 0, "replays": 0})[what] += 1

    def call(self, sig: Signature, fn, bound: inspect.BoundArguments,
             tensors: dict):
        entry = self.entries.get(sig)
        dev = next(iter(tensors.values())).device
        with torch.cuda.device(dev):
            if entry is None:
                entry = self._capture(sig, fn, bound, tensors, dev)
                while len(self.entries) >= MAX_GRAPHS:
                    self.entries.popitem(last=False)
                self.entries[sig] = entry
            else:
                self.entries.move_to_end(sig)
                with span("graphs.copy_in"):
                    for name, t in tensors.items():
                        entry.inputs[name].copy_(t)
            t0 = time.perf_counter()
            with span("graphs.replay"):
                entry.graph.replay()
            self._count(sig.fn, "replays")
            with span("graphs.copy_out"):
                out = _unflatten(entry.spec,
                                 iter([t.clone() for t in entry.outputs]))
            first = self.firsts.get(sig)
            if first is not None and "replay_ms" not in first:
                torch.cuda.synchronize(dev)
                first["replay_ms"] = _ms(t0)
            return out

    def _capture(self, sig, fn, bound, tensors, dev) -> _Entry:
        if dev not in self.pools:
            self.pools[dev] = torch.cuda.graph_pool_handle()
            self.streams[dev] = torch.cuda.Stream(dev)
        stream, pool = self.streams[dev], self.pools[dev]
        inputs = {name: torch.empty_like(t).copy_(t)
                  for name, t in tensors.items()}
        bound.arguments.update(inputs)
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _set("inline"), torch.cuda.stream(stream):
            fn(*bound.args, **bound.kwargs)                # the warm-up
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)     # the card idle as the capture begins
        warmup_ms = _ms(t0)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)   # for kernel_nodes
        try:
            with _set("inline"), torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn(*bound.args, **bound.kwargs)
                finally:
                    ended = _end_capture(graph, dev, pool)
                if ended is not None:
                    raise ended
            graph.instantiate()
            outputs = []
            spec = _flatten(out, outputs)
        except Exception as err:
            clear()
            raise GraphCaptureError(
                f"capturing {sig} into a CUDA graph failed: {err}") from err
        self._count(sig.fn, "captures")
        self.firsts[sig] = {"warmup_ms": warmup_ms, "capture_ms": _ms(t0)}
        return _Entry(graph, inputs, outputs, spec)

    def pool_bytes(self) -> int:
        """Bytes the graphs' pools hold on the card (their segments)."""
        ids = {tuple(pool) for pool in self.pools.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in ids)


def _end_capture(graph, dev, pool):
    """End the stream's capture; return the error ``capture_end`` raised
    (an invalidated capture), or None. After such an error the caching
    allocator may still route the thread's allocations to the pool, so
    this stops it."""
    try:
        graph.capture_end()
        return None
    except Exception as err:    # torch.AcceleratorError is no RuntimeError
        try:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
        except Exception:
            pass    # capture_end had stopped it before it raised
        return err


_cache = _Cache()


def stats() -> dict:
    """``{function name: {"captures": n, "replays": n}}`` since the last
    :func:`clear`. The first call with a signature counts one capture and
    one replay."""
    return {fn: dict(c) for fn, c in _cache.counts.items()}


def first_calls() -> list:
    """``[(str(signature), {"warmup_ms", "capture_ms", "replay_ms"})]`` in
    the order of capture: the host milliseconds of each first call since
    the last :func:`clear`, in its three parts -- the eager warm-up
    (through a synchronize), the capture and the graph's instantiation,
    and the first replay with its outputs' clones (through a
    synchronize)."""
    return [(str(sig), dict(parts)) for sig, parts in _cache.firsts.items()]


def kernel_nodes(last: int = 1) -> dict:
    """``{kernel name: nodes}`` of the ``last`` graphs used most recently,
    from the graphs themselves (the driver's node lists): the kernels each
    of their replays launches, exactly, where the profiler's records of
    a replay can come up short (it drops a record now and then)."""
    out = {}
    for entry in list(_cache.entries.values())[-last:]:
        for name, n in _graph_kernels(entry.graph.raw_cuda_graph()).items():
            out[name] = out.get(name, 0) + n
    return out


def _graph_kernels(raw: int) -> dict:
    """``{kernel name: nodes}`` of a ``cudaGraph_t``, by the driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def ok(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(ptr(raw), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    ok(cu.cuGraphGetNodes(ptr(raw), nodes, ctypes.byref(n)),
       "cuGraphGetNodes")
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 64.
        params = (ctypes.c_uint8 * 128)()
        ok(cu.cuGraphKernelNodeGetParams_v2(ptr(node), params),
           "cuGraphKernelNodeGetParams")
        func = ptr.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ptr(func)),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name),
                                  ptr(ptr.from_buffer(params, 64).value)),
               "cuKernelGetName")
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out


def pool_bytes() -> int:
    """Bytes of device memory the cached graphs' pool holds."""
    return _cache.pool_bytes()


def cached() -> int:
    """How many graphs the cache holds."""
    return len(_cache.entries)


def clear() -> None:
    """Drop every cached graph, its pool and :func:`stats` (as
    ``jax.clear_caches()`` does for compiled programs)."""
    global _cache
    had_pools = bool(_cache.pools)
    _cache = _Cache()
    if had_pools:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def compiled(fn):
    """Decorator: the counterpart of ``functools.partial(jax.jit,
    static_argnames=...)`` with every argument that is not a tensor static,
    so hashable."""
    params = inspect.signature(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _flag("disabled") or _flag("inline"):
            return fn(*args, **kwargs)
        bound = params.bind(*args, **kwargs)
        bound.apply_defaults()
        tensors, fixed = {}, {}
        for name, value in bound.arguments.items():
            if isinstance(value, torch.Tensor):
                tensors[name] = value
            else:
                try:
                    hash(value)
                except TypeError:
                    raise TypeError(f"{fn.__name__}: argument {name!r} is "
                                    f"neither a tensor nor hashable") from None
                fixed[name] = value
        if (not any(t.is_cuda for t in tensors.values())
                or torch.cuda.is_current_stream_capturing()):
            return fn(*args, **kwargs)
        with span("graphs.key"):
            sig = signature(fn.__name__, tensors, fixed)
            gated = captures(sig)
        if not gated:
            with _set("inline"):
                return fn(*args, **kwargs)
        return _cache.call(sig, fn, bound, tensors)

    return call
