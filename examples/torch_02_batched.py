"""Batched inversion on the port: 64 matrices of 128x128 in one launch of
kernel K1 (port of ``examples/02_batched.py``; the reference has no batched
mode).

    python examples/torch_02_batched.py [cpu]
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu_torch as mi

device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
batch = np.random.default_rng(1).uniform(0, 100, (64, 128, 128)).astype(np.float32)
inv, ok = mi.inverse(torch.from_numpy(batch).to(device))   # one K1 launch
print("all ok:", bool(ok.all()), "shape:", tuple(inv.shape))
