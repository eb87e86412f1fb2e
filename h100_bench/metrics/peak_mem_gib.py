"""The process's peak of allocated device memory, set-up included
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(record):
    peak = record.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
