"""``api.matrix_inv_32(flat, n)``, the shipped flat API, on a host float32
vector; it returns a host vector, empty where the matrix is singular."""

INPUTS = "host"


def bind(device):
    from gpu_matrix_inversion_tpu_torch import api

    def call(x, n):
        out = api.matrix_inv_32(x, n, device=device)
        return out, None, out.size == n * n
    return call
