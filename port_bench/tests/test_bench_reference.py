"""The yardstick: operation and byte counts, the frozen generator and the
plain reference."""

import numpy as np
import pytest
import torch

from port_bench.reference import counts, inverse
from port_bench.reference.generators import hollow


def test_counts_against_hand_values():
    assert counts.inverse_flops(128, 4096) == pytest.approx(17.18e9,
                                                            rel=1e-3)
    assert counts.inverse_flops(4096) == pytest.approx(137.4e9, rel=1e-3)
    assert counts.inverse_bytes(128, 4096) == 4096 * 8 * 128 ** 2
    # 4096 x 128^2 is bound by its operations: 17.18 GFLOP / 67 TFLOP/s.
    assert counts.bound_s(counts.inverse_flops(128, 4096),
                          counts.inverse_bytes(128, 4096)) == \
        pytest.approx(0.2564e-3, rel=1e-3)
    # 64 x 128^2: 4.0 us of operations against 2.5 us of bytes.
    assert counts.bound_s(counts.inverse_flops(128, 64),
                          counts.inverse_bytes(128, 64)) == \
        pytest.approx(4.007e-6, rel=1e-3)
    # In float64 the same operations take twice as long (34 TFLOP/s).
    assert counts.bound_s(counts.inverse_flops(4096), counts.inverse_bytes(
        4096, itemsize=8), "float64") == pytest.approx(4.042e-3, rel=1e-3)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_device_generator_is_hollow_and_repeatable(seed):
    a = hollow.device(seed, (3, 64, 64), device="cpu")
    assert a.dtype == torch.float32
    assert torch.equal(a.diagonal(dim1=-2, dim2=-1), torch.zeros(3, 64))
    off = a[:, ~torch.eye(64, dtype=torch.bool)]
    assert float(off.min()) >= 0.0 and float(off.max()) < 100.0
    assert float(off.min()) > 0.0      # nothing else is zeroed
    assert torch.equal(a, hollow.device(seed, (3, 64, 64),
                                               device="cpu"))
    assert not torch.equal(a, hollow.device(seed + 1, (3, 64, 64),
                                                   device="cpu"))


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_host_generator_is_hollow_and_repeatable(seed):
    vecs = hollow.host(seed, 2, 50)
    for v in vecs:
        assert v.dtype == np.float32 and v.shape == (2500,)
        m = v.reshape(50, 50)
        assert not np.diag(m).any()
        off = m[~np.eye(50, dtype=bool)]
        assert off.min() > 0 and off.max() < 100
    again = hollow.host(seed, 2, 50)
    assert all(np.array_equal(x, y) for x, y in zip(vecs, again))
    assert not np.array_equal(vecs[0], vecs[1])


@pytest.mark.parametrize("n,batch", [(1, 2), (5, 3), (33, 2), (64, 1),
                                     (100, 2)])
def test_reference_inverts_tiny_inputs(n, batch):
    a = hollow.device(n, (batch, n, n), device="cpu").double()
    if n == 1:
        a += 1.0
    x, ok = inverse.inverse(a, block=16)
    assert ok.all()
    want = torch.linalg.inv(a)
    assert torch.allclose(x, want, rtol=1e-9, atol=1e-12)


def test_reference_keeps_the_input_shape_and_flags_singular():
    a = torch.tensor([[0.0, 2.0], [3.0, 0.0]], dtype=torch.float64)
    x, ok = inverse.inverse(a)
    assert x.shape == (2, 2) and bool(ok)
    assert torch.allclose(x, torch.tensor([[0.0, 1 / 3], [0.5, 0.0]],
                                          dtype=torch.float64))
    sing = torch.ones((2, 4, 4), dtype=torch.float64)
    sing[1] = torch.eye(4)
    _, ok = inverse.inverse(sing)
    assert ok.tolist() == [False, True]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-11 + 2**-12,
                      1.0 + 3 * 2**-11, -3.0, 0.0])
    r = inverse.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-10, 1.0 + 2**-9,
                          -3.0, 0.0]


def test_the_tf32_reference_is_coarser_than_fp32():
    a = hollow.device(3, (4, 96, 96), device="cpu")
    exact, _ = inverse.inverse(a.double())
    x32, _ = inverse.inverse(a)
    x19, _ = inverse.inverse(a, gemm="tf32")
    err = lambda x: float(((x.double() - exact).norm() / exact.norm()))  # noqa: E731
    assert err(x19) > 100 * err(x32)
