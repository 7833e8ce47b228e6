"""Host-side utilities: validation, generators, residuals, timing, the
kernel build, and FP32 matmul precision."""
