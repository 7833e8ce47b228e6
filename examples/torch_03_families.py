"""Solver families on the port: Gauss-Jordan (fused/blocked), LU, Cholesky
(SPD), Newton-Schulz polish, mixed-precision refinement (port of
``examples/03_families.py``).

    python examples/torch_03_families.py [cpu]
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu_torch as mi
from gpu_matrix_inversion_tpu_torch.ops import (lu_factor_blocked,
                                                lu_solve_fast,
                                                lu_inverse_refined)

device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
n = 512
a_np = np.random.default_rng(2).uniform(0, 100, (n, n)).astype(np.float32)
np.fill_diagonal(a_np, 0)
a = torch.from_numpy(a_np).to(device)

x_gj, _ = mi.inverse(a, method="blocked")     # panel kernels + GEMMs
x_lu, _ = mi.inverse(a, method="lu")          # blocked getrf + getri

# Solve without forming the inverse (the reference can't):
b = torch.from_numpy(np.random.default_rng(3).standard_normal(
    (n, 4)).astype(np.float32)).to(device)
lu, perm, ok = lu_factor_blocked(a)
x, ok2 = lu_solve_fast(lu, perm, b)

# FP32 factor, FP64-level residual (BASELINE configs[3]):
x_ref, _ = lu_inverse_refined(a, iters=2, residual_dtype=torch.float64)

# SPD input: Cholesky potri -- half the LU operations, no pivot search,
# and the determinant falls out of either factorization:
spd = (a @ a.T) / n + n * torch.eye(n, device=device)
x_spd, ok_spd = mi.inverse(spd, method="cholesky")
sign, logabs, _ = mi.slogdet(a)

# Config-driven session (the reference's #define knobs at runtime):
inv = mi.Inverter(dtype="float32", method="blocked", refine_iters=1,
                  device=device)
x_best, ok3 = inv.inverse(a_np)
print("done:", bool(ok), bool(ok2), bool(ok3), bool(ok_spd))
