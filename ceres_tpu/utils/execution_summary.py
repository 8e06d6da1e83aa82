"""Per-call execution statistics.

reference: ExecutionSummary + ScopedExecutionTimer (execution_summary.h:89),
which accumulate cumulative call counts and seconds per call-site name
("Evaluator::Residual", "Evaluator::Jacobian", "LinearSolver::Solve",
program_evaluator.h:140-144) and surface them through
Evaluator::Statistics() into Summary::FullReport.

Nuance: inside the device-fused LM loop (solvers/fused_loop.py) the
individual residual/Jacobian/linear-solve timings cannot be separated —
one chunk is ONE device program; XLA has no clock op. Counts are exact
everywhere; seconds are exact per recorded name. Fused chunks therefore
record their (exact, cumulative) wall time under "FusedLoop::Chunk" while
the per-phase names keep exact counts with zero seconds, and the report
marks them as timed inside the chunk. The host trust-region loop (and any
solve with fused_execution=False, or fused_execution_chunk_iters=1 which
makes chunk time == iteration time) gives the fully separated timings the
reference reports.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class ExecutionSummary:
    """Cumulative (calls, seconds) per call-site name."""

    def __init__(self):
        self._stats = {}  # name -> [calls, seconds]

    def record(self, name: str, seconds: float, calls: int = 1) -> None:
        ent = self._stats.setdefault(name, [0, 0.0])
        ent[0] += calls
        ent[1] += seconds

    @contextmanager
    def scoped(self, name: str):
        """ScopedExecutionTimer (execution_summary.h:64-87): times the
        with-block and records one call. The caller must put the device
        sync (scalar fetch) inside the block for honest timings."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def calls(self, name: str) -> int:
        return self._stats.get(name, [0, 0.0])[0]

    def seconds(self, name: str) -> float:
        return self._stats.get(name, [0, 0.0])[1]

    def names(self):
        return sorted(self._stats)

    def report_lines(self):
        """Formatted block for Summary.full_report()."""
        if not self._stats:
            return []
        lines = [
            "Per-call statistics          calls      total s      mean ms",
        ]
        for name in self.names():
            calls, secs = self._stats[name]
            if secs == 0.0 and calls > 0:
                lines.append(
                    f"  {name:<26s}{calls:>6d}   (timed inside FusedLoop::Chunk)"
                )
            else:
                mean_ms = secs / calls * 1000.0 if calls else 0.0
                lines.append(
                    f"  {name:<26s}{calls:>6d} {secs:>12.6f} {mean_ms:>12.3f}"
                )
        return lines
