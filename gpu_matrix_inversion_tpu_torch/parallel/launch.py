"""Start the ranks of a ``torch.distributed`` world on one host.

:func:`spawn_ranks` runs a module-level function of this package on
``world`` fresh processes (the ``spawn`` start method), joined through a
``FileStore`` in a temporary directory, so no TCP port is taken: gloo
ranks on the CPU, or one NCCL rank per card. The multi-rank logic of
``parallel/`` is tested this way on the CPU, against the JAX package's
virtual 8-device mesh. :func:`world` joins one rank to a world over such
a store (a world of one rank in a script, a test or the sweep CLI). Under
``torchrun`` the caller initializes the process group itself and needs
none of this.

:func:`dryrun_multichip` is the port of ``__graft_entry__.py``'s dry run:
the sharded paths at real panel widths on ``n`` gloo ranks.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def world(backend: str, rank: int = 0, size: int = 1, *,
          store: str | None = None, timeout: float = 600.0):
    """Join a ``torch.distributed`` world of ``size`` ranks as ``rank``,
    through a ``FileStore`` at ``store`` (by default one in a new temporary
    directory, removed on exit; no TCP port), and destroy the process group
    on exit. ``backend`` is ``"nccl"`` (this rank on card ``rank``) or
    ``"gloo"``; ``timeout`` seconds bound its set-up and every
    collective."""
    tmp = None
    if store is None:
        tmp = tempfile.mkdtemp(prefix="matinv_world_")
        store = os.path.join(tmp, "store")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, size: int, tmp: str, device_type: str,
               timeout: float, results) -> None:
    """One rank: join the world, run the pickled call, report its result
    (or the traceback) to the parent as pickled bytes."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        with world("nccl" if device_type == "cuda" else "gloo", rank, size,
                   store=os.path.join(tmp, "store"), timeout=timeout):
            out = fn(*args)
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(world: int, fn, *args, device_type: str = "cpu",
                timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on each rank of a new world of ``world`` processes
    and return their results in rank order.

    ``fn`` is a module-level function of this package (the children import
    it by name, and nothing else of the caller's). ``device_type`` is
    ``"cpu"`` (gloo) or ``"cuda"`` (NCCL, rank r on card r). Each rank runs
    with one intra-op thread. ``timeout`` seconds bound the process group
    (its set-up and every collective) and the whole call: a rank still
    running then is killed. A rank that raises fails the call with its
    traceback, and the others are killed.
    """
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got "
                         f"{device_type!r}")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="matinv_ranks_")
    # The call goes through a file, not the start pipe: a child reads its
    # start data while it imports, so a large argument there would hold
    # each start until the previous child had imported torch.
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, tmp, device_type, timeout,
                               results))
             for rank in range(world)]
    out, errors = [None] * world, []
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.start()
        for _ in range(world):
            try:
                rank, good, payload = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                errors.append(f"timed out after {timeout} s")
                break
            if not good:
                errors.append(f"rank {rank}:\n{payload}")
                break
            out[rank] = pickle.loads(payload)
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"spawn_ranks({world}, {fn.__name__}) failed: "
                           + "\n".join(errors))
    return out


def run_calls(calls) -> list:
    """Rank body for :func:`spawn_ranks`: run each call on this rank.

    Each call is ``(fn, mesh_shape, axis_names, args, kwargs)``: ``fn``
    (a function of this package that takes ``mesh=``) runs on a mesh of
    that shape over the world, its numpy arguments moved to this rank's
    device as tensors; with ``mesh_shape`` None, ``fn`` runs without a
    mesh. Returns, per call, ``{"out": fn's result (a tuple's tensors
    moved to the CPU), "collectives": ..., "updates": ...}``: the
    collectives and window GEMMs this rank ran in the call
    (``sharded.collective.calls``, ``sharded.window_update.calls``).
    """
    from gpu_matrix_inversion_tpu_torch.parallel import sharded
    from gpu_matrix_inversion_tpu_torch.parallel.mesh import (
        default_platform, make_device_mesh)

    platform = default_platform()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if platform == "cuda" else torch.device("cpu"))
    meshes, done = {}, []
    for fn, shape, names, args, kwargs in calls:
        if shape is not None:
            key = (tuple(shape), tuple(names))
            if key not in meshes:
                meshes[key] = make_device_mesh(shape, names,
                                               platform=platform)
            kwargs = {**kwargs, "mesh": meshes[key]}
        args = [torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray)
                else x for x in args]
        before = (sharded.collective.calls, sharded.window_update.calls)
        got = fn(*args, **kwargs)
        if isinstance(got, tuple):
            got = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                        for x in got)
        done.append({"out": got,
                     "collectives": sharded.collective.calls - before[0],
                     "updates": sharded.window_update.calls - before[1]})
    return done


def _dryrun_rank(n_devices: int) -> None:
    """The dry run's body on one rank (``__graft_entry__.py:63-105``)."""
    from gpu_matrix_inversion_tpu_torch.parallel.mesh import make_device_mesh
    from gpu_matrix_inversion_tpu_torch.parallel.sharded import (
        sharded_batched_inverse, sharded_blocked_inverse)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    rng = np.random.default_rng(1)
    # 1-D tensor-parallel mesh at the default b = 128 and group width:
    # real shard widths, multi-panel groups, slot deposits, the final
    # gather.
    mesh = make_device_mesh(n_devices, ("x",), platform="cpu")
    n = 2048
    a = rng.uniform(0.0, 100.0, (n, n)).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    inv, ok = sharded_blocked_inverse(torch.from_numpy(a), mesh=mesh)
    if not bool(ok):
        raise RuntimeError("1-D sharded inversion flagged failure")
    resid = np.linalg.norm(a.astype(np.float64) @ inv.numpy() - np.eye(n))
    if not resid / n < 1e-3:
        raise RuntimeError(f"1-D sharded inversion inaccurate: {resid}")
    # 2-D dp x tp mesh at b = 128 with gw = 384 straddling the 512-wide
    # tp shards (tp = 4).
    if n_devices % 2 == 0 and n_devices >= 4:
        dp, tp = 2, n_devices // 2
        mesh2 = make_device_mesh((dp, tp), ("dp", "tp"), platform="cpu")
        nb = 768 if tp == 4 else 128 * tp
        batch = np.stack([rng.uniform(0.0, 100.0, (nb, nb)).astype(
            np.float32) for _ in range(2 * dp)])
        for mat in batch:
            np.fill_diagonal(mat, 0.0)
        invb, okb = sharded_batched_inverse(torch.from_numpy(batch),
                                            mesh=mesh2, block_size=128,
                                            group_size=3)
        if not bool(okb.all()):
            raise RuntimeError("dp x tp batched inversion failed")
        for i in range(batch.shape[0]):
            r = relative_residual(batch[i], invb[i].numpy())
            if not r < 1e-4:
                raise RuntimeError(f"dp x tp inversion inaccurate: {r}")


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded paths once on ``n_devices`` gloo ranks: a 2048^2
    matrix on a 1-D mesh at the default geometry, then (for an even
    ``n_devices`` >= 4) a batch on a (2, n/2) mesh at b = 128, group 3.
    Raises on any failure."""
    spawn_ranks(n_devices, _dryrun_rank, n_devices, device_type="cpu")
