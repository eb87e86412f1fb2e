"""The omics benchmark evaluator: inference JSONL -> per-task metrics.

A copy of ``molly_tpu.evalsuite`` (numpy, scipy and sklearn; no JAX), kept
here because the port imports nothing of the JAX package.
``tests/test_torch_evalsuite.py`` holds the copy against the original: the
same JSONL gives the same scores.
"""

from .harness import evaluate_file, evaluate_task, group_entries, load_entries
from .registry import TASK_REGISTRY, get_base_task_name
from . import metrics
