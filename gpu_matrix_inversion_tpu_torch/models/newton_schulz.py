"""Newton-Schulz iterative inversion: a second solver family.

Port of ``gpu_matrix_inversion_tpu/models/newton_schulz.py``. A^-1 is the
fixed point of the quadratically convergent iteration

    X_{k+1} = X_k (2I - A X_k)

started from the Pan-Reif guess ``X_0 = A^T / (||A||_1 ||A||_inf)``, which
gives ||I - A X_0|| < 1 for any nonsingular A in exact arithmetic (the
speed of convergence falls with the conditioning). Each step is two GEMMs,
with no pivoting and no data-dependent control flow. They are plain GEMMs,
which the reference leaves to XLA, so here they are library calls: FP32
steps in true FP32 (TF32 off), and the ``mixed`` early steps as bf16 GEMMs.
Use cases: well-conditioned matrices and warm starts.
"""

from __future__ import annotations

import torch

from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision


@compiled
def newton_schulz_inverse(a: torch.Tensor, *, iters: int = 30,
                          mixed: bool = False):
    """Invert ``(..., n, n)`` by Newton-Schulz on ``a``'s device; returns
    ``(inv, ok)``.

    Args:
      iters: fixed iteration count (about 2 bits of accuracy doubling per
        step once contracting).
      mixed: run the first 2/3 of the iterations in bfloat16, the rest in
        ``a``'s dtype.

    ``ok`` is the normwise relative backward error gate of the reference:
    ``||I - A X||_F < tol * ||A||_F ||X||_F`` (tol 1e-4, 1e-12 for fp64)
    and X finite, so rescaling A never flips it.
    """
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")
    n = a.shape[-1]
    dtype = a.dtype
    eye = torch.eye(n, dtype=dtype, device=a.device)

    # Pan-Reif start: X0 = A^T / (||A||_1 ||A||_inf).
    norm1 = a.abs().sum(dim=-2).amax(dim=-1)      # max column sum
    norminf = a.abs().sum(dim=-1).amax(dim=-1)    # max row sum
    denom = (norm1 * norminf)[..., None, None]
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    x = a.transpose(-1, -2) / denom

    lo = int(iters * 2 / 3) if mixed else 0

    def step(x, dt):
        xl, al = x.to(dt), a.to(dt)
        return xl @ (2 * eye.to(dt) - al @ xl)

    with matmul_precision("highest"):
        for i in range(iters):
            x = step(x, torch.bfloat16 if i < lo else dtype)
        x = x.to(dtype)
        r = eye - a @ x
    rnorm, anorm, xnorm = (torch.sqrt((t * t).sum(dim=(-2, -1)))
                           for t in (r, a, x))
    scale = torch.clamp(anorm * xnorm, min=torch.finfo(dtype).tiny)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    ok = (rnorm < tol * scale) & torch.isfinite(x).all(dim=(-2, -1))
    return x, ok
