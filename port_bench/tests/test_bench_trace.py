"""The reduction of a traced segment: busy union, kernel names, the check
of records against launches, the breakdown and the metric readers."""

import pytest

from port_bench.core import spec, trace
from port_bench.reference import counts


def test_union_merges_overlaps_and_clips_to_the_window():
    rows = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 1.0),
            ("d", 10.0, 5.0)]
    busy, gaps = trace.union_s(rows, 0.0, 12.0)
    assert busy == pytest.approx(1.5 + 1.0 + 2.0)
    assert gaps == [(1.5, 3.0), (4.0, 10.0)]


@pytest.mark.parametrize("mangled,want", [
    ("_Z27panel_factor_cluster_kernelILb1ELb0EEvPKfPKiPiPfS3_S4_iiiiii",
     "panel_factor_cluster_kernel"),
    ("_ZN2at6native13reduce_kernelILi512ELi1ENS0_8ReduceOpIbEEEEvT1_",
     "reduce_kernel"),
    ("spin_kernel", "spin_kernel"),
])
def test_base_name_reads_the_function_out_of_a_mangled_name(mangled, want):
    assert trace.base_name(mangled) == want


def test_shortfall_names_kernels_the_records_lack():
    device = [("void panel_factor_cluster_kernel<true, false>(...)", 0, 1)] \
        * 31 + [("fused_gj_regs_kernel", 0, 1)] * 2
    want = {"panel_factor_cluster_kernel": 32,
            "fused_gj_regs_kernel|fused_gj_cluster_kernel": 2}
    assert trace.shortfall(want, device) == {
        "panel_factor_cluster_kernel": (32, 31)}
    assert trace.shortfall({"fused_gj_regs_kernel": 2}, device) == {}


def test_breakdown_labels_gaps_by_the_innermost_host_span():
    device = [("k1", 0.0, 1.0), ("k1", 2.0, 1.0), ("copy", 3.5, 0.1)]
    host = [("port_bench::segment", -1.0, 10.0),
            ("port_bench::call", 0.0, 3.0), ("aten::gather", 1.2, 0.6),
            ("port_bench::call", 3.3, 1.0)]
    _, gaps = trace.union_s(device, -1.0, 9.0)
    out = trace.breakdown(device, host, gaps)
    assert out["device_ops"][0] == ["k1", 2.0]
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"aten::gather": 1.0, "port_bench::segment": 0.5})


def _segment(records, calls=10, n=128, batch=4096, busy=0.9, window=1.0,
             replayed=0):
    work = {"flops": calls * counts.inverse_flops(n, batch),
            "bytes": calls * counts.inverse_bytes(n, batch),
            "dtype": "float32"}
    return trace.Segment(calls, window, busy, records,
                         {"replayed_calls": replayed}, work)


def test_fused_roofline_reads_the_calls_device_time():
    k1 = [("void fused_gj_regs_kernel<4>(...)", 0.0, 2.0e-3)] * 10
    other = [("gather", 0.0, 0.2e-3)] * 10 + \
        [("Memcpy DtoH (Device -> Pageable)", 0.0, 1.0)]
    seg = _segment(k1 + other)
    want = 100 * counts.bound_s(seg.work["flops"], seg.work["bytes"]) / 22e-3
    assert spec.reader("fused_roofline")(seg) == pytest.approx(want)
    assert spec.reader("fused_roofline")(_segment(other)) is None


def test_blocked_readers():
    recs = [("void panel_factor_cluster_kernel<true, false>()", 0, 1e-3),
            ("gemm", 0, 1.5e-3), ("Memcpy DtoD (Device -> Device)", 0, 5e-4),
            ("Memcpy HtoD (Pageable -> Device)", 0, 7e-3),
            ("Memcpy DtoH (Device -> Pageable)", 0, 3e-3)]
    seg = _segment(recs, calls=1, n=4096, batch=1, busy=0.013,
                   window=0.026, replayed=1)
    assert spec.reader("blocked.panel_pct")(seg) == pytest.approx(100 / 3)
    assert spec.reader("blocked_roofline")(seg) == pytest.approx(
        100 * counts.inverse_flops(4096) / 67e12 / 3e-3)
    assert spec.reader("api.copy_ms")(seg) == pytest.approx(10.0)
    assert spec.reader("graphs.replay_pct")(seg) == 100.0
    for cells in ("single", "batched", "flat"):
        assert spec.reader(f"device.idle_pct.{cells}")(seg) == \
            pytest.approx(50.0)
    assert spec.reader("api.copy_ms")(_segment(recs[:2])) is None
