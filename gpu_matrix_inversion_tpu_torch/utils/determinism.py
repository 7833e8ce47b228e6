"""Determinism checking: the port's race check.

Port of ``gpu_matrix_inversion_tpu/utils/determinism.py``. The reference
implementation ships no sanitizers; the JAX package catches unstable
reductions, uninitialised scratch and races in hand-written kernels the way
a race detector would: run the computation several times, with scratch
poisoned in between, and demand bit-identical results.

On a CUDA device the poison between runs is real:

- :func:`poison_allocator` fills every free block that PyTorch's caching
  allocator holds with 0xFF bytes (NaN in fp32, bf16 and fp64) and frees
  it again, so a kernel's scratch or output that is read before it is
  written comes back as NaN where it held the last run's values. The blocks
  come from ``torch.cuda.memory_snapshot()``: a single large allocation
  would not reuse the small cached blocks that a kernel's scratch comes
  from. The free blocks of the CUDA graphs' pool (``utils/graphs.py``),
  where a replayed graph keeps its scratch, are filled in place: no
  allocation outside a capture reaches them.
- :func:`poison_shared_memory` launches ``csrc/poison.cu``, one block an SM
  at the largest dynamic shared memory a block may take, filling each SM's
  shared memory with 0xFF. The kernels that keep their working sets on
  chip (K1, K2, K3, K6) would otherwise find the same leftovers in every
  run, which hides an uninitialised read.

On the CPU the reference's cheap dummy computation stands in.

The first run is eager (``graphs.disabled()``), the rest go through the
compiled routes' graphs, so on the card the check also holds a captured
and replayed route to its eager bits.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Callable, Tuple

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.utils import cuda_build, graphs

_CHUNK = 1 << 20   # the caching allocator's small-pool limit (1 MiB)


def _leaves(out) -> list:
    """The tensors (and scalars) of ``out``, flattened as ``jax.tree``
    flattens: sequences in order, dicts by sorted key."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for item in out for x in _leaves(item)]
    return [out]


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()      # exact; numpy has no bf16
        return x.cpu().numpy()
    return np.asarray(x)


def _device_of(args, out) -> torch.device:
    """The device of the first tensor argument, else of the first tensor
    the call returned."""
    for x in [*_leaves(list(args)), *_leaves(out)]:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def poison_allocator(device, value: int = 0xFF) -> int:
    """Fill every free block of the caching allocator on ``device`` with
    ``value`` bytes, then free them again; returns the bytes filled. Each
    free block is taken by allocations of its own size
    (at most 1 MiB each in the small pool, whose blocks a larger request
    would not reach); best fit hands back those very blocks, largest
    first. What was taken is filled and released together at the end."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    free, in_graphs = [], []
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != index:
            continue
        private = tuple(seg["segment_pool_id"]) != (0, 0)
        for block in seg["blocks"]:
            if block["state"] == "inactive":
                if private:
                    in_graphs.append((block["address"], block["size"]))
                else:
                    free.append((block["size"], seg["segment_type"]))
    free.sort(reverse=True)
    held = []
    with torch.cuda.device(device):
        for size, pool in free:
            while size > 0:
                part = min(size, _CHUNK) if pool == "small" else size
                held.append(torch.empty(part, dtype=torch.uint8,
                                        device=device))
                size -= part
        for t in held:
            t.fill_(value)
        for address, size in in_graphs:
            _over(address, size, device).fill_(value)
    return (sum(size for size, _ in free)
            + sum(size for _, size in in_graphs))


class _Raw:
    """``size`` bytes at ``address`` on the card, as a
    ``__cuda_array_interface__`` that ``torch.as_tensor`` wraps without
    copying or owning."""

    def __init__(self, address: int, size: int):
        self.__cuda_array_interface__ = {
            "shape": (size,), "typestr": "|u1", "data": (address, False),
            "strides": None, "version": 3}


def _over(address: int, size: int, device) -> torch.Tensor:
    """A uint8 tensor over memory the allocator holds but no tensor uses."""
    return torch.as_tensor(_Raw(address, size), device=device)


def poison_shared_memory(device) -> tuple[int, int]:
    """Fill each SM's shared memory on ``device`` with 0xFF
    (``csrc/poison.cu``); returns ``(SMs reached, bytes a block)``. Two
    blocks an SM are launched, at the opt-in maximum of dynamic shared
    memory each, so no two run on one SM at once and every SM takes one."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    smids = torch.full((2 * sms,), -1, dtype=torch.int32, device=device)
    smem = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_build.load().matinv_poison_shared(
            smids.numel(), smids.data_ptr(), ctypes.byref(smem),
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(err, "poison_shared")
    poison_shared_memory.launches += 1
    return int(torch.unique(smids).numel()), smem.value


poison_shared_memory.launches = 0


def _perturb(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        poison_allocator(device)
        poison_shared_memory(device)
        torch.cuda.synchronize(device)
    else:
        # The reference's dummy computation: an unrelated shape of NaNs.
        junk = torch.full((257, 129), float("nan"), device=device)
        (junk * junk).sum()


def check_deterministic(fn: Callable, *args, runs: int = 3,
                        perturb: bool = True) -> Tuple[bool, float]:
    """Run ``fn(*args)`` ``runs`` times; return ``(bit_identical,
    max_diff)``.

    ``fn`` may return a tensor, or a tuple, list or dict of them. Floats
    compare with NaN equal to NaN, ``max_diff`` being the largest float64
    |a - b|; any integer or bool mismatch gives ``inf``. ``perturb=True``
    poisons the device between runs (see the module docstring); the device
    is that of the tensor arguments, or of ``fn``'s result when it takes
    none. The first run is eager (``graphs.disabled()``), the others reach
    the compiled routes' graphs: the first of them captures a route's
    graph, the rest replay it.
    """
    outs = []
    device = None
    for i in range(runs):
        if perturb and i > 0:
            _perturb(device)
        if i == 0:
            with graphs.disabled():
                out = fn(*args)
        else:
            out = fn(*args)
        if device is None:
            device = _device_of(args, out)
        outs.append([_to_host(x) for x in _leaves(out)])
        del out    # its blocks are poisoned before the next run too
    max_diff = 0.0
    identical = True
    first = outs[0]
    for other in outs[1:]:
        for a, b in zip(first, other):
            if a.dtype.kind in "fc":
                if not np.array_equal(a, b, equal_nan=True):
                    identical = False
                    diff = np.abs(a.astype(np.float64) -
                                  b.astype(np.float64))
                    with warnings.catch_warnings():
                        # All NaN (a value against NaN) reads as nan, which
                        # max() passes over, as in the reference.
                        warnings.simplefilter("ignore", RuntimeWarning)
                        max_diff = max(max_diff, float(np.nanmax(diff)))
            elif not np.array_equal(a, b):
                identical = False
                max_diff = float("inf")
    return identical, max_diff
