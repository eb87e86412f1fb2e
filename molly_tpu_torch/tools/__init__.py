"""Data tools and the checkpoint parity runner.

``data_tools`` and ``cli`` are copies of ``molly_tpu.tools.data_tools`` and
``molly_tpu.tools.cli`` (pandas, sklearn; no JAX); ``parity`` holds the port
against HF transformers (``python -m molly_tpu_torch.tools.parity``).
"""

from . import data_tools
from .data_tools import (
    balanced_subsample,
    check_data_leak,
    convert_inference_jsonl,
    dataset_stats,
    filter_by_markers,
    jsonl_to_parquet,
    merge_parquets,
    records_to_parquet,
    replace_reserved_tokens,
    split_by_task,
    validate_tagged_sequences,
)
