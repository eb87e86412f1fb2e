from .logging import (
    MetricLogger,
    domain_loss_metrics,
    is_main_process,
    print_rank_0,
    time_count,
)
