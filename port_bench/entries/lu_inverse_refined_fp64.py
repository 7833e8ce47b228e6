"""``ops.lu_inverse_refined(a, iters=2, residual_dtype=torch.float64)`` on a
card tensor: the FP32 LU inverse refined by two Newton-Schulz steps in
float64. The caller reads ``ok`` on the host, as it does before it uses the
answer."""

INPUTS = "device"


def bind(device):
    import torch

    from gpu_matrix_inversion_tpu_torch import ops

    def call(x, n):
        inv, ok = ops.lu_inverse_refined(x, iters=2,
                                         residual_dtype=torch.float64)
        return inv, ok, bool(ok.all())
    return call
