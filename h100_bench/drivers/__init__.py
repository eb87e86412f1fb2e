"""Window loops, one an entry point of the program: ``<driver>.run(cell)``
returns a ``harness.result.Outcome``."""
