"""The yardstick: the frozen input generator, the plain reference inverse,
and the operation and byte counts with the card's peaks. Imports nothing
of the program and nothing of JAX."""
