"""Benchmark harnesses reproducing the reference's experiment protocol:
the per-phase breakdown (``phases.py``) and the sweep CLI (``sweep.py``)."""
