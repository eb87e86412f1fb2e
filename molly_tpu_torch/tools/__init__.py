"""Data tools, the checkpoint parity runner, and the embedding, judge and
CoT tools.

``data_tools``, ``cli`` and ``cot_gen`` are copies of the JAX package's
modules of those names (pandas, sklearn, stdlib; no JAX); ``parity`` holds
the port against HF transformers (``python -m
molly_tpu_torch.tools.parity``); ``embed`` and ``llm_judge`` run on this
package's models and engine.
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
from .llm_judge import judge_records, parse_verdict, strip_think
