"""The general part of the benchmark: finding a cell's files by name, the
weights and traffic drawn from the seed, the trace reduction, the result."""
