"""Checkpoint / resume of solver state.

The reference has none (optimization state lives in user arrays; re-calling
Solve resumes — SURVEY.md §5). Long multi-device runs make restarts expensive,
so this module adds real checkpointing: parameter state + trust-region
radius + iteration counters, saved atomically as .npz. A callback is
provided for periodic saving during long solves, and `solve` options can
resume from a checkpoint file.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from .types import CallbackReturnType


@dataclasses.dataclass
class Checkpoint:
    state: np.ndarray
    trust_region_radius: float
    iteration: int
    cost: float

    def save(self, path: str):
        """Atomic write (tmp + rename) so a crash never corrupts it."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    state=self.state,
                    trust_region_radius=np.float64(self.trust_region_radius),
                    iteration=np.int64(self.iteration),
                    cost=np.float64(self.cost),
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        with np.load(path) as z:
            return cls(
                state=np.asarray(z["state"]),
                trust_region_radius=float(z["trust_region_radius"]),
                iteration=int(z["iteration"]),
                cost=float(z["cost"]),
            )


class CheckpointCallback:
    """IterationCallback that snapshots the problem every `every` accepted
    iterations. Attach to SolverOptions.callbacks and set
    `update_state_every_iteration=True` so the program's state vector
    tracks the current iterate (reference analog: StateUpdatingCallback)."""

    def __init__(self, problem, path: str, every: int = 10):
        self.problem = problem
        self.path = path
        self.every = max(1, every)

    def __call__(self, it_sum):
        if it_sum.iteration % self.every == 0 and it_sum.step_is_successful:
            program = self.problem.compile()
            ckpt = Checkpoint(
                state=np.asarray(program.state0),
                trust_region_radius=float(it_sum.trust_region_radius),
                iteration=int(it_sum.iteration),
                cost=float(it_sum.cost),
            )
            ckpt.save(self.path)
        return CallbackReturnType.SOLVER_CONTINUE


def resume_problem_from(problem, path: str) -> Checkpoint:
    """Load a checkpoint and write its parameter state into the problem.
    Returns the checkpoint so the caller can seed
    SolverOptions.initial_trust_region_radius."""
    ckpt = Checkpoint.load(path)
    program = problem.compile()
    program.write_state_back(ckpt.state)
    return ckpt
