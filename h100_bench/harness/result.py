"""What a run hands back, and the result line it prints."""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Outcome:
    """A driver's account of one run. ``end_to_end`` maps a metric name to
    its value (the harness keeps the cell's own); ``record`` is what the
    per-layer readers read; ``checks`` are (name, value, limit) triples,
    each passing when value <= limit."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: Dict[str, Any]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for _, v, lim in
                                        self.checks)


def check_lines(outcome: Outcome) -> List[str]:
    return [f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if value <= limit else 'FAILED'}"
            for name, value, limit in outcome.checks] + [
        f"check failed_requests {outcome.failed} limit 0 "
        f"{'ok' if outcome.failed == 0 else 'FAILED'}"]


def emit(line: Dict[str, Any], outcome: Outcome) -> None:
    """The check lines last on standard error, the JSON line last on
    standard output."""
    sys.stdout.flush()
    for text in check_lines(outcome):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def result_line(outcome: Outcome, metrics: Dict[str, Dict[str, Any]],
                device: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    line: Dict[str, Any] = {"correct": outcome.correct,
                            "attempted": outcome.attempted,
                            "failed": outcome.failed, "metrics": metrics,
                            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    line["checks"]["failed_requests"] = {"value": outcome.failed,
                                         "limit": 0}
    return line
