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


class FakeCache:
    """The program's graph cache as the records check sees it: graphs kept
    in the order of their last use, replays counted by function, each
    graph's kernel nodes."""

    def __init__(self, nodes: dict):
        self.nodes = nodes                    # key -> {kernel: nodes}
        self.order = list(nodes)              # oldest first
        self.replays = {}

    def replay(self, key):
        self.order.remove(key)
        self.order.append(key)
        self.replays[key.fn] = self.replays.get(key.fn, 0) + 1

    def state(self):
        return dict(self.replays), tuple(self.order)

    def kernel_nodes(self, last=1):
        """``graphs.kernel_nodes``: ``last=0`` reads every graph."""
        out = {}
        for key in self.order[-last:]:
            for name, n in self.nodes[key].items():
                out[name] = out.get(name, 0) + n
        return out

    def session(self, calls):
        """The states a traced session reads: before the first call and
        after each; ``calls``: the graphs each call replays."""
        states = [self.state()]
        for keys in calls:
            for key in keys:
                self.replay(key)
            states.append(self.state())
        return states


class Key(tuple):
    """A graph's key: its function and signature."""
    fn = property(lambda self: self[0])


PANEL = "_Z27panel_factor_cluster_kernelILb1ELb1EEvPKfPKiPiPfS3_S4_iiiiii"
GEMM32 = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8"
GEMM64 = "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize128x64x16"
L4 = "_ZN12_GLOBAL__N_121lu_factor_grid_kernelIfEEvPfPiS1_iii"
L5 = "_ZN12_GLOBAL__N_115lu_solve_kernelIfEEvPKfPKiPfiii"
BLOCKED = Key(("blocked_inverse", 4096))
LU = Key(("lu_inverse", 4096))
NS = Key(("newton_schulz_refine", 4096))
K1 = "|".join(trace.kernels.K1)


def _parent_want(cache, replays, k1_launches):
    """The parent's want: the graph used last, times every replay."""
    want = {}
    if replays:
        for name, n in cache.kernel_nodes(last=1).items():
            key = trace.base_name(name)
            want[key] = want.get(key, 0) + n * replays
    if k1_launches:
        want[K1] = k1_launches
    return want


def _want(cache, states, k1_launches=0):
    return trace.expected(trace.graph_replays(states), states[-1][1],
                          k1_launches, cache.kernel_nodes)


@pytest.mark.parametrize("k1_launches", [0, 40])
def test_one_graph_a_call_wants_what_the_parent_wanted(k1_launches):
    cache = FakeCache({NS: {GEMM64: 4}, LU: {L4: 1, L5: 1},
                       BLOCKED: {PANEL: 32, GEMM32: 64, GEMM64: 3}})
    states = cache.session([[BLOCKED]] * 40)
    want = _want(cache, states, k1_launches)
    assert want == _parent_want(cache, 40, k1_launches)
    assert want["panel_factor_cluster_kernel"] == 32 * 40
    assert trace.replayed_calls(states) == 40


def test_k1_alone_wants_its_launches():
    cache = FakeCache({BLOCKED: {PANEL: 32}})
    states = cache.session([[]] * 200)
    assert _want(cache, states, 200) == _parent_want(cache, 0, 200) \
        == {K1: 200}
    assert trace.replayed_calls(states) == 0


def test_two_graphs_a_call_want_each_its_own_replays():
    """``lu_inverse_refined``: the LU graph, then the Newton-Schulz one;
    the parent counted the Newton-Schulz graph twice a call."""
    cache = FakeCache({BLOCKED: {PANEL: 32}, NS: {GEMM64: 4},
                       LU: {L4: 1, L5: 1}})
    states = cache.session([[LU, NS]] * 10)
    want = _want(cache, states)
    assert want == {"lu_factor_grid_kernel": 10, "lu_solve_kernel": 10,
                    GEMM64: 40}
    assert _parent_want(cache, 20, 0) == {GEMM64: 80}
    assert trace.shortfall(want, [(GEMM64, 0, 1)] * 40 + [
        ("void (anonymous namespace)::lu_factor_grid_kernel<float>()",
         0, 1)] * 10 + [("lu_solve_kernel", 0, 1)] * 10) == {}
    assert trace.replayed_calls(states) == 10


def test_a_different_graph_each_call_wants_each_graphs_replays():
    """A sweep: one function, a graph an order, cycled call by call."""
    sizes = [Key(("blocked_inverse", n)) for n in (1024, 2048, 4096)]
    nodes = {key: {PANEL: n // 128, GEMM32: n // 64}
             for key, n in zip(sizes, (1024, 2048, 4096))}
    cache = FakeCache({LU: {L4: 1}} | nodes)
    calls = [[sizes[i % 3]] for i in range(7)]
    want = _want(cache, cache.session(calls))
    assert want == {"panel_factor_cluster_kernel": 3 * 8 + 2 * 16 + 2 * 32,
                    GEMM32: 3 * 16 + 2 * 32 + 2 * 64}


def test_replays_beyond_a_functions_graphs_go_to_the_one_used_last():
    cache = FakeCache({BLOCKED: {PANEL: 32}, NS: {GEMM64: 4}})
    states = cache.session([[NS, NS]] * 3)
    assert trace.graph_replays(states) == {NS: 6}
    assert _want(cache, states) == {GEMM64: 24}


def test_a_graph_no_longer_cached_is_left_out():
    cache = FakeCache({NS: {GEMM64: 4}, LU: {L4: 1}})
    states = cache.session([[LU, NS]] * 2)
    replays = trace.graph_replays(states)
    assert trace.expected(replays, (NS,), 0, cache.kernel_nodes) == {
        GEMM64: 8}


def test_graph_state_reads_the_programs_cache():
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    graphs.clear()
    assert trace.graph_state() == ({}, ())


def _innermost_idle(segment):
    """A reader as a later one would be: each idle gap of the segment put
    down to the innermost ``matinv::`` span open at its middle."""
    out = {}
    for start, end in segment.gaps:
        mid = (start + end) / 2
        open_ = [h for h in segment.host if h[0].startswith("matinv::")
                 and h[1] <= mid <= h[1] + h[2]]
        if open_:
            name = max(open_, key=lambda h: h[1])[0]
            out[name] = out.get(name, 0.0) + end - start
    return out


def test_the_segment_keeps_the_host_spans_and_the_gaps():
    device = [("k", 0.0, 1.0), ("k", 2.0, 1.0), ("k", 3.5, 0.5),
              ("k", 20.0, 1.0)]
    host = [("port_bench::segment", -1.0, 10.0),
            ("port_bench::call", 0.0, 3.2),
            ("matinv::solver.inverse", 0.1, 3.0),
            ("matinv::graphs.replay", 1.1, 0.8),
            ("port_bench::call", 3.3, 1.0)]
    seg, out = trace.assemble(2, 10.0, device, host,
                              {"replayed_calls": 2}, {})
    assert seg.host == host
    assert seg.gaps == [(1.0, 2.0), (3.0, 3.5)]
    assert seg.busy_s == pytest.approx(2.5)
    assert _innermost_idle(seg) == pytest.approx(
        {"matinv::graphs.replay": 1.0})
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"matinv::graphs.replay": 1.0, "port_bench::segment": 0.5})
    assert trace.Segment(1, 1.0, 1.0, [], {}, {}).gaps == []
