"""Basic usage of the PyTorch/CUDA port: the reference's product API and
the high-level API (port of ``examples/01_basic.py``).

    python examples/torch_01_basic.py          # on the CUDA card
    python examples/torch_01_basic.py cpu      # the kernels' plain twins

Reference equivalent: MATLAB `clib.matInv.matrix_inv_32(b, N)` via clibgen
(README.md:49-51) or C++ `matrix_inversion_FP32(vector, N)` (headers.h:8).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu_torch as mi

device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
n = 256
a = np.random.default_rng(0).uniform(0, 100, (n, n)).astype(np.float32)
np.fill_diagonal(a, 0)  # the reference's "hollow" test matrices

# Flat row-major vector in, flat inverse out, EMPTY on invalid/singular.
out = mi.matrix_inv_32(a.reshape(-1), n, device=device)
assert out.size == n * n

# High-level API on a tensor: (inverse, ok), the route chosen by shape.
x, ok = mi.inverse(torch.from_numpy(a).to(device))
print("ok:", bool(ok), "max|A@X - I|:",
      float(np.abs(a @ x.cpu().numpy() - np.eye(n)).max()))

# Singular input -> empty vector (reference mat_inv_32.cpp:389-394).
print("singular ->", mi.matrix_inv_32(np.ones(16, np.float32), 4,
                                      device=device).size, "elements")
