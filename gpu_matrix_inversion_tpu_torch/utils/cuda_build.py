"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every source under ``csrc/`` for ``sm_90a`` (one compiler
process per source, all started together) and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The library
lands in ``build/torch_kernels/`` beside the package, named by a content
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing builds at import: the first kernel launch calls
:func:`load`. The build needs only the repository's sources and the CUDA
toolkit (``nvcc`` on ``PATH``, under ``$CUDA_HOME`` or ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of csrc/*.cu: name -> argtypes (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    # a, inv, pos, ok, batch, m, pivot, bf16, cluster, smem, stream
    "matinv_fused_gj": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # blocks (int *)
    "matinv_fused_gj_occupancy": (_P,),
    # m, cluster, smem, clusters (int *)
    "matinv_fused_clusters": (_I, _I, _I, _P),
    # stripT, used, pivrows, ct, ok, wp, m, b, sub, kmask, kb, pivot,
    # cluster, threads, wp_shared, rows_shared, smem, stream
    "matinv_panel_factor": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P),
    # stripT, used, pivrows, w, wp, m, b, sub, kmask, bf16, cluster,
    # threads, wp_shared, rows_shared, smem, stream
    "matinv_pivot_search": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P),
    # kind, m, b, sub, cluster, threads, wp_shared, rows_shared, smem,
    # clusters (int *)
    "matinv_panel_clusters": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # a, inv, ok, batch, b, pivot, stream
    "matinv_small_inv": (_P, _P, _P, _I, _I, _I, _P),
    # a, out, ok, batch, b, stream
    "matinv_small_lu": (_P, _P, _P, _I, _I, _P),
    # stripT, used, pivrows, ct, ok, wp, k, m, b, sub, kmask, kb, pivot,
    # cluster, threads, wp_shared, rows_shared, smem, stream
    "matinv_lockstep_factor": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P),
    # a, b, c, m, n, k, lda, ldb, bf16, stream
    "matinv_tiled_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # blocks, smids, smem_bytes (int *), stream
    "matinv_poison_shared": (_I, _P, _P, _P),
    # a, out, perm, ok, work, props, bar, flags, batch, n, fp64, lu, pivot,
    # branch, ctas, rows_shared, smem, stream (L1 with lu 0, L4 with 1)
    "matinv_gauss_jordan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P),
    # n, fp64, lu, cluster, smem, clusters (int *)
    "matinv_gauss_jordan_clusters": (_I, _I, _I, _I, _I, _P),
    # strip, lds, used, pivrows, ok, work, props, bar, m, b, kb, fp64,
    # pivot, ctas, rows_shared, smem, stream
    "matinv_logical_panel": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P),
    # strip, lds, used, w, used_out, pivrows, ok, work, props, bar, m, b,
    # kb, fp64, pivot, ctas, rows_shared, smem, stream
    "matinv_lu_panel": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P),
    # a, out, perm, ok, work, props, bar, flags, marks, batch, n, fp64,
    # pivot, ctas, panel, smem, stream
    "matinv_lu_factor_blocked": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _P),
    # lu, perm, b, x, flags, work, batch, n, k, kc, cluster, fp64, stream
    "matinv_lu_solve": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmatinv_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.

    Each source compiles in its own ``nvcc -c`` process, all at once, then
    one ``nvcc -shared`` links them. The compilers' ``-Xptxas -v`` reports
    (registers, shared memory, spills per kernel) are kept beside the
    library as ``<name>.ptxas.txt``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    report = [proc.communicate()[0] for proc in procs]
    for src, proc, text in zip(sources, procs, report):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{text}")
    tmp = out.with_name(f"{tag}.tmp.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    out.with_name(out.stem + ".ptxas.txt").write_text("".join(report))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.matinv_error_string.argtypes = [ctypes.c_int]
        lib.matinv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = _lib.matinv_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")


def capturing() -> bool:
    """Whether the current stream is recording a CUDA graph, where a
    launch is recorded and does not run (``utils/graphs.py``); False on a
    PyTorch built without CUDA."""
    import torch
    return (torch.version.cuda is not None
            and torch.cuda.is_current_stream_capturing())
