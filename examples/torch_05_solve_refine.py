"""Linear solves and mixed-precision refinement on the port (port of
``examples/05_solve_refine.py``).

    python examples/torch_05_solve_refine.py [cpu]

The reference only ever forms explicit inverses (its README concedes to
LAPACK's LU solves, README.md:62); this library ships the LAPACK-shaped
path too: getrf/getrs triangular solves plus classic iterative refinement
reusing the factorization (the dsgesv pattern), and a config-driven
session object replacing the reference's compile-time `#define` variant
selection (main_file.cpp:14-18).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu_torch as mi

device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
n = 512
rng = np.random.default_rng(5)
a_np = rng.uniform(0, 100, (n, n)).astype(np.float32)
np.fill_diagonal(a_np, 0)
b_np = rng.standard_normal((n, 4)).astype(np.float32)
a = torch.from_numpy(a_np).to(device)
b = torch.from_numpy(b_np).to(device)

# LU solve (auto-routes to blocked getrf + triangular solves at this size).
x, ok = mi.solve(a, b)
print("solve ok:", bool(ok),
      "rel err:", float(np.linalg.norm(a_np @ x.cpu().numpy() - b_np)
                        / np.linalg.norm(b_np)))

# Iterative refinement: fp32 factorization, near-fp64 solution quality.
xr, okr = mi.solve(a, b, refine_iters=2)
print("refined rel err:", float(np.linalg.norm(a_np @ xr.cpu().numpy() - b_np)
                                / np.linalg.norm(b_np)))

# Session API: pick dtype/method/refinement once, reuse everywhere
# (the runtime replacement for the reference's #define matrix).
inv = mi.Inverter(dtype="float32", method="blocked", refine_iters=1,
                  device=device)
xi, oki = inv.inverse(a_np)
print("Inverter ok:", bool(oki), "max|A@X - I|:",
      float(np.abs(a_np @ xi.cpu().numpy() - np.eye(n)).max()))
