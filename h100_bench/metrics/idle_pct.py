"""Share of a batch in which no kernel, copy or set ran on the device: one
less the busy seconds of the batch run again under the profiler (the union
of their intervals in the trace; two streams at once count once) over the
seconds the same batch took in the untraced window. The profiler slows
the host, not the device, so its own length is not the denominator."""


def read(record):
    s, batch = record.get("trace"), record.get("profiled")
    if s is None or batch is None or batch["untraced_s"] <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / batch["untraced_s"])
