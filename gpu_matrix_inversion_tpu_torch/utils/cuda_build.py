"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every source under ``csrc/`` for ``sm_90a`` into one
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of csrc/*.cu: name -> argtypes (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    # a, inv, pos, ok, work, batch, m, pivot, bf16, stream
    "matinv_fused_gj": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # stripT, used, pivrows, ct, ok, wp, m, b, sub, kmask, kb, pivot, stream
    "matinv_panel_factor": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
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

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.ptxas.txt``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    out.with_name(out.stem + ".ptxas.txt").write_text(proc.stdout
                                                      + proc.stderr)
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
