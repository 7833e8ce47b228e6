"""PyTorch/CUDA port of ``gpu_matrix_inversion_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; each module here has exactly
one counterpart there, and the tests hold the two against each other. This
port carries:

- the flat-vector API (``api.py``) and the ``Res`` bench records;
- ``inverse`` with the ``auto``, ``spec``, ``fused``, ``blocked``, ``lu``
  and ``ns`` routes, ``solve``, and the config-driven ``Inverter`` with
  ``InversionConfig`` (``models/solver.py``, ``utils/config.py``);
- the fused route through kernel K1 (``csrc/fused_gj.cu``); the blocked
  route through kernel K2 (``csrc/panel_factor.cu``), or past its gate
  the split path through K3 (the pivot search) and K4
  (``csrc/small_inv.cu``), plus GEMMs and a Newton-Schulz polish; FP64
  through K3's f32-search tier or the plain logical panel; with
  ``MATINV_LOCKSTEP=1``, FP32 batches through the lockstep route, k
  matrices per launch of kernel K6 (``csrc/panel_factor.cu``);
- the LU route (getrf through K3 and K5, ``csrc/small_lu.cu``; getri by
  triangular inversion), ``det`` and ``slogdet`` (``ops/lu.py``);
- the Newton-Schulz family (``models/newton_schulz.py``) and the
  verification GEMM ``tiled_matmul``, kernel K7 (``csrc/tiled_matmul.cu``,
  ``ops/matmul.py``).

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
from gpu_matrix_inversion_tpu_torch.ops.lu import (det, invert_triangular,
                                                   slogdet)
from gpu_matrix_inversion_tpu_torch.models.solver import (Inverter, inverse,
                                                         solve)
from gpu_matrix_inversion_tpu_torch.utils.config import InversionConfig

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
    "det",
    "slogdet",
    "invert_triangular",
    "inverse",
    "solve",
    "Inverter",
    "InversionConfig",
    "__version__",
]
