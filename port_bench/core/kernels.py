"""The program's kernel names that the benchmark reads, as the profiler
records them, in one place: the traced segment's check of records against
launches (``core/trace.py``) and the per-layer metrics use these."""

# K1, the fused route (``csrc/fused_gj.cu``), launched eagerly.
K1 = ("fused_gj_regs_kernel", "fused_gj_cluster_kernel")
# The blocked route's panel kernels (``csrc/panel_factor.cu``): K2, and
# K3, its search-only mode.
PANEL = ("panel_factor_cluster_kernel", "pivot_search_cluster_kernel")
