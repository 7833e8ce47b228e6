"""Compute: the plain-torch spec, kernel K1 (fused), kernel K2 with the
blocked driver, and Newton-Schulz refinement."""
