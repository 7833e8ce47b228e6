"""PyTorch/CUDA port of ``gpu_matrix_inversion_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; each module here has exactly
one counterpart there, and the tests hold the two against each other. This
first slice carries the shipped product call ``matrix_inv_32`` end to end:

- the flat-vector API (``api.py``) and the ``Res`` bench records;
- ``inverse`` with the ``auto``, ``spec``, ``fused`` and ``blocked`` routes
  (``models/solver.py``);
- the fused route through kernel K1 (``csrc/fused_gj.cu``) and the blocked
  route through kernel K2 (``csrc/panel_factor.cu``) plus FP32 GEMMs and a
  Newton-Schulz polish.

The kernels are CUDA C++ for ``sm_90a``, built with ``nvcc`` on first use
(``utils/cuda_build.py``); importing the package builds nothing. Every
tensor-level function runs on its input's device; the flat numpy API takes
``device="cuda"`` by default, and uses the CPU (through the kernels' plain
PyTorch twins) only when ``device="cpu"`` is passed.
"""

from gpu_matrix_inversion_tpu_torch.api import (
    Res,
    matrix_inv_32,
    matrix_inversion_fp32,
    matrix_inversion_fp64,
    matrix_inversion_no_pivots,
    fp32_bench,
    fp64_bench,
    no_pivots_bench,
    matrix_multiply,
)
from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    gauss_jordan_inverse)
from gpu_matrix_inversion_tpu_torch.models.solver import inverse

__version__ = "0.1.0"

__all__ = [
    "Res",
    "matrix_inv_32",
    "matrix_inversion_fp32",
    "matrix_inversion_fp64",
    "matrix_inversion_no_pivots",
    "fp32_bench",
    "fp64_bench",
    "no_pivots_bench",
    "matrix_multiply",
    "gauss_jordan_inverse",
    "inverse",
    "__version__",
]
