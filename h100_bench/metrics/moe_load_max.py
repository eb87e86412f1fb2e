"""How unevenly the router loads the experts in the prefill: 100 x the
busiest expert's routed rows over the mean rows an expert (the program's
counters ``moe_expert_rows_max`` and ``moe_expert_rows_mean``, each summed
over the prefill's MoE layers), over the stats batches. 100 is an even
load; the grouped GEMMs' time follows the busiest group. None where the
program counts neither."""

from h100_bench.metrics._recorded import stats_of


def read(record):
    batches = stats_of(record, "counts")
    if batches is None:
        return None
    mean = sum(s["counts"].get("moe_expert_rows_mean", 0) for s in batches)
    if not mean:
        return None
    return 100.0 * sum(s["counts"].get("moe_expert_rows_max", 0)
                       for s in batches) / mean
