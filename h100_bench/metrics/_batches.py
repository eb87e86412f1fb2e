"""The batches a traced run ran again after its window with ``stats``
(which synchronizes between phases): the per-batch stage metrics are read
from them, so the window itself runs untraced."""


def stat_mean_ms(record, key):
    """Milliseconds of ``stats[key]`` a batch, over the stats batches of a
    traced run; None in an untraced one."""
    batches = [b for b in record.get("stats_batches") or [] if b["stats"]]
    if not batches:
        return None
    return 1e3 * sum(b["stats"][key] for b in batches) / len(batches)
