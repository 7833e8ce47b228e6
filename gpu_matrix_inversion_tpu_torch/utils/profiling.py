"""Observability: the startup device dump and the per-phase report.

Port of the two pieces of ``gpu_matrix_inversion_tpu/utils/profiling.py``
that the verbose ``matrix_inversion_fp32`` path uses. The reference prints
its CL_DEVICE_* attributes at startup and a per-phase trace with derived
GFLOPS afterwards (``matrix_inversion_FP32.cpp:304-333``, ``:711-723``).
"""

from __future__ import annotations

import torch


def device_info(device="cuda") -> dict:
    """Device-capability dump (reference FP32.cpp:304-333 prints max
    workgroup size, global/local memory and compute units). On a CUDA
    device the counterparts are the SM count, device memory and the
    opt-in shared memory per block, which bounds the fused kernel's
    shared-memory branch (ops/fused.py)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"backend": device.type, "device_count": 1}
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    props = torch.cuda.get_device_properties(index)
    entry = {
        "id": index,
        "name": props.name,
        "compute_capability": f"{props.major}.{props.minor}",
        "multi_processor_count": props.multi_processor_count,
        "total_memory_bytes": props.total_memory,
        "shared_memory_per_block_optin_bytes": getattr(
            props, "shared_memory_per_block_optin", None),
        "l2_cache_bytes": getattr(props, "L2_cache_size", None),
    }
    return {
        "backend": "cuda",
        "torch_cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "devices": [{k: v for k, v in entry.items() if v is not None}],
    }


def print_phase_report(res, order: int, out=None) -> None:
    """Per-phase stdout trace + derived GFLOPS (reference's verbose paths)."""
    import sys
    out = out or sys.stdout
    t = res.times
    print(f"matrix order: {order}", file=out)
    for key in ("buffers", "compile", "make_augmented", "pivot", "row",
                "column", "total_compute", "identity_check",
                "get_inverted", "total"):
        if key in t:
            print(f"  {key:>14}: {t[key] * 1e3:10.3f} ms", file=out)
    if getattr(res, "identity_error", None) is not None:
        # Strict identity self-check (reference FP32.cpp:814-835).
        print(f"  {'max|AX-I|':>14}: {res.identity_error:10.3e}", file=out)
    tc = t.get("total_compute")
    if tc:
        # The reference's fixColumn flop model: 4*N^3 total
        # (matrix_inversion_FP64.cpp:753-755).
        print(f"  {'gflops(4N^3)':>14}: {4 * order**3 / tc / 1e9:10.1f}",
              file=out)
    print(f"  {'status':>14}: {'ok' if res.ok else 'FAILED'}", file=out)
