"""Compute: the plain-torch spec, kernel K1 (fused), kernel K2 with the
blocked driver, and Newton-Schulz refinement."""

from gpu_matrix_inversion_tpu_torch.ops.refine import (lu_inverse_refined,
                                                       newton_schulz_refine)

__all__ = ["newton_schulz_refine", "lu_inverse_refined"]
