"""Run configuration: the reference's compile-time flags as a dataclass.

Port of ``gpu_matrix_inversion_tpu/utils/config.py``. The reference selects
variant, size, pivoting and seed with compile-time ``#define FP32 / N / REP
/ PIVOTS / RAND`` (``main_file.cpp:14-18``); here the same knobs are set
from keyword arguments or ``MATINV_*`` environment variables.
:func:`enable_compile_cache` keeps what the port compiles, its kernel
library, where the JAX package's keeps JAX's compiled programs.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass
class InversionConfig:
    """All knobs of an inversion run (reference main_file.cpp:14-18)."""

    dtype: str = "float32"        # FP32/FP64 variant selection
    pivot: bool = True            # PIVOTS
    method: str = "auto"          # which algorithm family
    block_size: int = 128         # blocked-path panel width
    precision: str = "highest"    # GEMM precision of the trailing updates
    search_bf16: bool = False     # bfloat16 pivot-search data (blocked path)
    refine_iters: int = 0         # Newton-Schulz refinement steps
    repeat: int = 1               # REP (timed repetitions)
    seed: int = 0                 # RAND

    ENV_PREFIX = "MATINV_"

    @classmethod
    def from_env(cls, **overrides) -> "InversionConfig":
        """Read ``MATINV_*`` environment variables, then apply overrides."""
        kwargs = {}
        for field in dataclasses.fields(cls):
            raw = os.environ.get(cls.ENV_PREFIX + field.name.upper())
            if raw is None:
                continue
            if field.type == "bool":
                kwargs[field.name] = raw.lower() in ("1", "true", "yes", "on")
            elif field.type == "int":
                kwargs[field.name] = int(raw)
            else:
                kwargs[field.name] = raw
        kwargs.update(overrides)
        return cls(**kwargs)

    def validate(self) -> "InversionConfig":
        from gpu_matrix_inversion_tpu_torch.models.solver import METHODS
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"bad dtype {self.dtype!r}")
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}")
        if self.precision not in ("default", "high", "highest"):
            raise ValueError(f"bad precision {self.precision!r}")
        if self.block_size <= 0 or self.repeat <= 0:
            raise ValueError("block_size and repeat must be positive")
        return self


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel library's build cache at a directory (the
    counterpart of the JAX package's function, which points JAX's
    persistent compilation cache at one).

    ``nvcc`` builds ``csrc/*.cu`` into one library named by a hash of the
    sources (``utils/cuda_build.py``), by default under ``build/
    torch_kernels/`` beside the package; a later process with the same
    sources loads it instead of building. This moves that directory for
    the rest of the process. Disable with ``MATINV_COMPILE_CACHE=0`` (the
    default directory stays in use); relocate with
    ``MATINV_COMPILE_CACHE_DIR``. Returns the directory used, or None when
    disabled.

    The in-memory cache of CUDA graphs (``utils/graphs.py``, the port's
    counterpart of ``jax.jit``'s compiled programs) is not persisted: a
    CUDA graph cannot outlive its process.
    """
    if os.environ.get("MATINV_COMPILE_CACHE", "1").lower() in (
            "0", "false", "no", "off"):
        return None
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    if cache_dir is None:
        cache_dir = (os.environ.get("MATINV_COMPILE_CACHE_DIR")
                     or str(cuda_build.BUILD_DIR))
    cuda_build.BUILD_DIR = Path(cache_dir)
    return cache_dir
