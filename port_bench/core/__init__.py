"""The harness: discovery by name, the load generator, the traced
segment, the correctness check, the faults it is shown to catch, and the
program's kernel names that the readers use."""
