"""What the program's recorder (``molly_tpu_torch.utils.profiling``) wrote
into the stats batches a traced run runs again after its window:
``stats["spans"][name] = {"n", "host_s", "self_host_s", "sync_s",
"device_s"}`` and ``stats["counts"][name]``. A run whose stats batches hold
none (an untraced run, or a program that records nothing) gives None."""


def stats_of(record, key):
    """The stats batches' ``stats`` dicts, or None unless each holds
    ``key`` (``"spans"`` or ``"counts"``)."""
    batches = [b["stats"] for b in record.get("stats_batches") or []
               if b["stats"]]
    if not batches or any(key not in s for s in batches):
        return None
    return batches


def span_s(stats, name, field="host_s"):
    """Seconds of the span ``name`` in one batch (0 if it never ran):
    ``host_s``, or ``sync_s``, the host's time blocked in the
    ``molly/sync/*`` spans inside it."""
    span = stats["spans"].get(name)
    return span[field] if span else 0.0


def count_ratio_pct(record, live, run):
    """100 x the summed counter ``live`` over the summed ``run``."""
    batches = stats_of(record, "counts")
    if batches is None:
        return None
    total = sum(s["counts"].get(run, 0) for s in batches)
    if not total:
        return None
    return 100.0 * sum(s["counts"].get(live, 0) for s in batches) / total
