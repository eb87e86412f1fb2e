"""Operations and bytes of one operation at given shapes: one module an
operation, with a data file beside it that names the kernels that run it
(regular expressions over the profiler's kernel names)."""
