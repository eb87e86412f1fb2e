"""Milliseconds a decode step takes (forward through the dense cache, the
head and the sampler): ``stats["decode_s"] / stats["decode_steps"]`` over
every step of the batches a traced run runs again after its window."""


def read(record):
    batches = [b for b in record.get("stats_batches") or [] if b["stats"]]
    steps = sum(b["stats"].get("decode_steps", 0) for b in batches)
    if not steps:
        return None
    return 1e3 * sum(b["stats"]["decode_s"] for b in batches) / steps
