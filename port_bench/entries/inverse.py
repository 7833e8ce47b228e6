"""``models.solver.inverse(a)`` (``method="auto"``) on a card tensor; the
caller reads ``ok`` on the host, as it does before it uses the answer."""

INPUTS = "device"


def bind(device):
    from gpu_matrix_inversion_tpu_torch.models import solver

    def call(x, n):
        inv, ok = solver.inverse(x)
        return inv, ok, bool(ok.all())
    return call
