"""Host-side utilities: validation, generators, residuals, timing, tracing,
the determinism check, the kernel build, and FP32 matmul precision. The
same exports as the JAX package's ``utils``."""

from gpu_matrix_inversion_tpu_torch.utils.validation import (
    validate_flat_matrix)
from gpu_matrix_inversion_tpu_torch.utils.generators import (
    hollow_random_matrix,
    random_matrix,
    well_conditioned_matrix,
    ill_conditioned_matrix,
)
from gpu_matrix_inversion_tpu_torch.utils.residual import (
    relative_residual,
    reference_error_metric,
)
from gpu_matrix_inversion_tpu_torch.utils.res import Res, PhaseTimer
from gpu_matrix_inversion_tpu_torch.utils.config import InversionConfig
from gpu_matrix_inversion_tpu_torch.utils.determinism import (
    check_deterministic)
from gpu_matrix_inversion_tpu_torch.utils.profiling import (
    trace,
    device_info,
    print_phase_report,
)

__all__ = [
    "InversionConfig",
    "check_deterministic",
    "trace",
    "device_info",
    "print_phase_report",
    "validate_flat_matrix",
    "hollow_random_matrix",
    "random_matrix",
    "well_conditioned_matrix",
    "ill_conditioned_matrix",
    "relative_residual",
    "reference_error_metric",
    "Res",
    "PhaseTimer",
]
