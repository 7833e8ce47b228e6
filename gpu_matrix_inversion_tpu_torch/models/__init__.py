"""Algorithm dispatch (``solver.inverse``)."""
