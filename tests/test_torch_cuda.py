"""On-card checks of the port's CUDA kernels against their plain twins.

Marked ``gpu``: they need an NVIDIA Hopper GPU and ``nvcc``, and skip
without a CUDA device (decided inside the ``cuda`` fixture, so every
pytest worker collects the same tests). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have.)

Tolerances as in ``chip_smoke.py``: pivot sequences identical, ok equal,
values within 1e-4 of max|twin|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpu_matrix_inversion_tpu_torch.ops import blocked, fused  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(x, ref) -> float:
    return float((x.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("bsz,m,pivot,dtype", [
    (8, 128, True, torch.float32),     # shared-memory branch
    (8, 128, False, torch.float32),
    (8, 128, True, torch.bfloat16),
    (2, 256, True, torch.float32),     # global-workspace branch
    (1, 640, True, torch.float32),
])
def test_k1_matches_twin(cuda, bsz, m, pivot, dtype):
    rng = np.random.default_rng(m + bsz)
    a = rng.standard_normal((bsz, m, m)).astype(np.float32)
    if not pivot:
        a += m * np.eye(m, dtype=np.float32)
    x = torch.from_numpy(a).to(cuda).to(dtype)
    before = fused.gj_kernel.launches
    inv_k, pos_k, ok_k = fused.gj_kernel(x, pivot=pivot)
    assert fused.gj_kernel.launches == before + 1
    inv_t, pos_t, ok_t = fused.gj_twin(x, pivot=pivot)
    assert torch.equal(pos_k, pos_t)
    assert torch.equal(ok_k, ok_t) and bool(ok_k.all())
    assert _rel(inv_k, inv_t) <= 1e-4


@pytest.mark.parametrize("m,b,kb", [(256, 64, 0), (1024, 128, 128),
                                    (4096, 128, 0)])
def test_k2_matches_twin(cuda, m, b, kb):
    rng = np.random.default_rng(m + b)
    strip = torch.from_numpy(
        rng.standard_normal((b, m)).astype(np.float32)).to(cuda)
    used = torch.zeros(m, dtype=torch.int32, device=cuda)
    used[:kb] = 1
    p_k, ct_k, ok_k = blocked.panel_factor(strip, kb, used, pivot=True)
    p_t, ct_t, ok_t = blocked.panel_factor_twin(strip, kb, used, pivot=True)
    assert torch.equal(p_k, p_t)
    assert bool(ok_k) and bool(ok_t)
    assert not bool(used[p_k.long()].any())
    assert _rel(ct_k, ct_t) <= 1e-4


def test_k1_flags_singular_and_nan(cuda):
    a = torch.eye(128).repeat(3, 1, 1)
    a[1] = 1.0
    a[2, 3, 4] = float("nan")
    _, _, ok = fused.gj_kernel(a.to(cuda).contiguous(), pivot=True)
    assert ok.tolist() == [True, False, False]


def test_main_path_launches_kernels_and_repeats(cuda):
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)
    k1, k2 = fused.gj_kernel.launches, blocked.panel_factor.launches
    small = torch.from_numpy(hollow_random_matrix(200, seed=1)).to(cuda)
    inv, ok = inverse(small)
    assert bool(ok) and fused.gj_kernel.launches > k1
    big_np = hollow_random_matrix(1024, seed=2)
    big = torch.from_numpy(big_np).to(cuda)
    first, ok = inverse(big)
    assert bool(ok) and blocked.panel_factor.launches > k2
    second, _ = inverse(big)
    assert torch.equal(first, second)
    assert relative_residual(big_np, first.cpu().numpy()) < 1e-6
