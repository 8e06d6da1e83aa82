"""Problem modeling: parameter blocks, residual blocks, bounds, manifolds.

Capability parity with the reference Problem/ProblemImpl
(include/ceres/problem.h, internal/ceres/problem_impl.cc) and ProblemCUDA
(include/ceres/problem_cuda.h), re-designed for batched device evaluation:

- residual blocks are added in *batches* (`add_residual_blocks`) with stacked
  per-block data — the natural unit for XLA's static-shape compilation and the
  analog of the reference's per-type CUDA evaluator registration
  (problem_cuda.h:110-160). Single `add_residual_block` is a batch of one.
- `compile()` lowers the problem to a `Program`: signature-grouped index
  arrays + stacked data (see program.py), mirroring the reference's
  preprocess step (program.cc:306 CreateReducedProgram +
  registered_cuda_evaluators.cc:226 Init), but producing gather/scatter
  tables instead of device pointer patch-ups.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .autodiff import CostFunction
from .loss import LossFunction
from .manifolds import EuclideanManifold, Manifold


@dataclasses.dataclass(slots=True)
class _ParameterBlock:
    index: int
    values: np.ndarray  # current state (ambient), float64 host copy
    manifold: Optional[Manifold]
    constant: bool = False
    lower_bound: Optional[np.ndarray] = None
    upper_bound: Optional[np.ndarray] = None
    removed: bool = False

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @property
    def tangent_size(self) -> int:
        return self.manifold.tangent_size if self.manifold is not None else self.size


def _is_euclidean(m) -> bool:
    return m is None or isinstance(m, EuclideanManifold)


class _BlockStore:
    """Lazy columnar parameter-block storage.

    Blocks added in bulk (`add_parameter_blocks`) stay as ONE [n, size]
    matrix plus shared metadata; a `_ParameterBlock` object materializes
    only when a block is touched individually (constancy, bounds, manifold
    change, removal, value replacement). The vectorized column/state APIs
    below read the matrices directly and patch the (typically few)
    materialized rows — preprocessing cost is O(vector ops), not
    O(#blocks) Python-object work, which is what lets a million-point BA
    problem build faster than the reference's preprocessor (BASELINE.md).

    Supports the list protocol (`len`, indexing, iteration) so the rest of
    the code reads like a plain block list; iteration materializes and is
    therefore reserved for small/cold paths.
    """

    def __init__(self):
        self._ranges: list = []  # {start, n, size, manifold, values [n,s]}
        self._range_starts: list = []
        self._mat: dict = {}  # index -> _ParameterBlock (touched blocks)
        self._len = 0

    # ---- construction ------------------------------------------------ #

    def append_range(self, values: np.ndarray, manifold) -> int:
        start = self._len
        self._ranges.append(
            {
                "start": start,
                "n": int(values.shape[0]),
                "size": int(values.shape[1]),
                "manifold": manifold,
                "values": values,
            }
        )
        self._range_starts.append(start)
        self._len += int(values.shape[0])
        return start

    # ---- list protocol ----------------------------------------------- #

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i) -> _ParameterBlock:
        i = int(i)
        b = self._mat.get(i)
        if b is not None:
            return b
        if i < 0 or i >= self._len:
            raise IndexError(i)
        import bisect

        r = self._ranges[bisect.bisect_right(self._range_starts, i) - 1]
        b = _ParameterBlock(
            index=i, values=r["values"][i - r["start"]], manifold=r["manifold"]
        )
        self._mat[i] = b
        return b

    def __iter__(self):
        for i in range(self._len):
            yield self[i]

    # ---- vectorized fast paths --------------------------------------- #

    def columns(self):
        """(removed, constant, sizes, tsizes, manifold_ids, manifolds) —
        the per-block metadata columns, without materializing blocks."""
        nb = self._len
        removed = np.zeros(nb, dtype=bool)
        constant = np.zeros(nb, dtype=bool)
        sizes = np.zeros(nb, dtype=np.int64)
        tsizes = np.zeros(nb, dtype=np.int64)
        manifold_ids = np.full(nb, -1, dtype=np.int64)
        manifolds: list = []
        mindex: dict = {}

        def mid_of(m):
            mid = mindex.get(m)
            if mid is None:
                mid = len(manifolds)
                mindex[m] = mid
                manifolds.append(m)
            return mid

        for r in self._ranges:
            st, n, s, m = r["start"], r["n"], r["size"], r["manifold"]
            sizes[st : st + n] = s
            if _is_euclidean(m):
                tsizes[st : st + n] = s
            else:
                tsizes[st : st + n] = m.tangent_size
                manifold_ids[st : st + n] = mid_of(m)
        for i, b in self._mat.items():
            if b.removed:
                removed[i] = True
                constant[i] = False
                sizes[i] = 0
                tsizes[i] = 0
                manifold_ids[i] = -1
                continue
            constant[i] = b.constant
            sizes[i] = b.size
            if _is_euclidean(b.manifold):
                tsizes[i] = b.size
                manifold_ids[i] = -1
            else:
                tsizes[i] = b.manifold.tangent_size
                manifold_ids[i] = mid_of(b.manifold)
        # compact away manifolds left with no live members (e.g. a range
        # whose every block was individually overridden)
        used = np.unique(manifold_ids[manifold_ids >= 0])
        if used.size != len(manifolds):
            remap = np.full(len(manifolds) + 1, -1, dtype=np.int64)
            remap[used] = np.arange(used.size)
            manifold_ids = np.where(
                manifold_ids >= 0, remap[manifold_ids], -1
            )
            manifolds = [manifolds[int(u)] for u in used]
        return removed, constant, sizes, tsizes, manifold_ids, manifolds

    def removed_mask(self) -> np.ndarray:
        mask = np.zeros(self._len, dtype=bool)
        for i, b in self._mat.items():
            if b.removed:
                mask[i] = True
        return mask

    def num_removed(self) -> int:
        return sum(1 for b in self._mat.values() if b.removed)

    def fill_state(self, state0: np.ndarray, x_offsets: np.ndarray):
        """state0[x_offsets[i] : +size] = block i's values, vectorized."""
        for r in self._ranges:
            st, n, s = r["start"], r["n"], r["size"]
            offs = x_offsets[st : st + n]
            ok = offs >= 0
            rows = offs[ok, None] + np.arange(s)[None, :]
            state0[rows.reshape(-1)] = r["values"][ok].reshape(-1)
        for i, b in self._mat.items():
            if b.removed:
                continue
            o = int(x_offsets[i])
            if o >= 0:
                state0[o : o + b.size] = b.values

    def write_back(self, state: np.ndarray, x_offsets: np.ndarray):
        """Inverse of fill_state: range matrices (and any materialized
        blocks' arrays) take the solved values."""
        for r in self._ranges:
            st, n, s = r["start"], r["n"], r["size"]
            offs = x_offsets[st : st + n]
            ok = offs >= 0
            rows = offs[ok, None] + np.arange(s)[None, :]
            r["values"][ok] = state[rows.reshape(-1)].reshape(-1, s)
        for i, b in self._mat.items():
            # replaced (non-view) value arrays need their own write
            if b.removed:
                continue
            o = int(x_offsets[i])
            if o >= 0:
                b.values[:] = state[o : o + b.size]

    def bounds_any(self) -> bool:
        # bounds can only be set through a materialized block
        return any(
            (b.lower_bound is not None or b.upper_bound is not None)
            for b in self._mat.values()
            if not b.removed
        )

    def fill_bounds(self, lower, upper, x_offsets):
        for i, b in self._mat.items():
            if b.removed:
                continue
            o = int(x_offsets[i])
            if o < 0:
                continue
            if b.lower_bound is not None:
                lower[o : o + b.size] = b.lower_bound
            if b.upper_bound is not None:
                upper[o : o + b.size] = b.upper_bound


@dataclasses.dataclass
class _ResidualBatch:
    """A homogeneous batch of residual blocks added together."""

    cost_function: CostFunction
    loss: Optional[LossFunction]
    param_ids: np.ndarray  # [n, k] parameter block indices
    data: tuple  # tuple of [n, ...] arrays
    first_handle: int
    alive: np.ndarray  # [n] bool


class Problem:
    """Nonlinear least-squares problem under construction.

    reference: include/ceres/problem.h:127-574.
    """

    def __init__(self, evaluation_callback=None):
        """evaluation_callback(new_point: bool, evaluate_jacobians: bool) is
        invoked before each evaluation — the hook user code uses to refresh
        shared quantities (reference: evaluation_callback.h via
        Problem::Options::evaluation_callback)."""
        self._blocks = _BlockStore()
        self._batches: list[_ResidualBatch] = []
        self._next_residual_handle = 0
        # handles are assigned contiguously per batch, so handle -> (batch,
        # row) is a bisect over batch start handles (a per-handle dict costs
        # seconds at BAL scale — 5M inserts)
        self._batch_starts: list[int] = []
        self._num_removed_blocks = 0
        self._dirty = True
        self._program = None
        self.evaluation_callback = evaluation_callback

    def _locate_handle(self, handle: int) -> tuple:
        """(batch index, row) of a live residual-block handle."""
        import bisect

        h = int(handle)
        i = bisect.bisect_right(self._batch_starts, h) - 1
        if i < 0:
            raise KeyError(handle)
        batch = self._batches[i]
        row = h - batch.first_handle
        if row >= batch.alive.shape[0] or not batch.alive[row]:
            raise KeyError(handle)
        return i, row

    # ------------------------------------------------------------------ #
    # parameter blocks
    # ------------------------------------------------------------------ #

    def add_parameter_block(
        self, values, manifold: Optional[Manifold] = None
    ) -> int:
        """Add one parameter block; returns its integer handle.

        reference: Problem::AddParameterBlock (problem.cc).
        """
        v = np.asarray(values, dtype=np.float64).reshape(-1).copy()
        if v.size == 0:
            raise ValueError("parameter block must be non-empty")
        self._check_manifold(v.size, manifold)
        handle = self._blocks.append_range(v.reshape(1, -1), manifold)
        self._dirty = True
        return handle

    def add_parameter_blocks(
        self, values, manifold: Optional[Manifold] = None
    ) -> np.ndarray:
        """Bulk-add n blocks of equal size from a [n, size] array; returns
        their handles. Extension over the reference (no host loop at BA scale)."""
        v = np.asarray(values, dtype=np.float64)
        if v.ndim != 2:
            raise ValueError("add_parameter_blocks expects [n, size]")
        self._check_manifold(v.shape[1], manifold)
        # one private copy; any materialized block's values are row views
        start = self._blocks.append_range(v.copy(), manifold)
        self._dirty = True
        return np.arange(start, start + v.shape[0])

    @staticmethod
    def _check_manifold(size: int, manifold: Optional[Manifold]):
        if manifold is not None and manifold.ambient_size != size:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {size}"
            )

    def set_manifold(self, block: int, manifold: Optional[Manifold]):
        self._check_manifold(self._blocks[block].size, manifold)
        self._blocks[block].manifold = manifold
        self._dirty = True

    def set_parameter_block_constant(self, block: int):
        self._blocks[block].constant = True
        self._dirty = True

    def set_parameter_block_variable(self, block: int):
        self._blocks[block].constant = False
        self._dirty = True

    def is_parameter_block_constant(self, block: int) -> bool:
        return self._blocks[block].constant

    def set_parameter_lower_bound(self, block: int, index: int, value: float):
        b = self._blocks[block]
        if b.manifold is not None and not isinstance(b.manifold, EuclideanManifold):
            raise ValueError("bounds require a Euclidean parameter block")
        if b.lower_bound is None:
            b.lower_bound = np.full(b.size, -np.inf)
        b.lower_bound[index] = value
        self._dirty = True

    def set_parameter_upper_bound(self, block: int, index: int, value: float):
        b = self._blocks[block]
        if b.manifold is not None and not isinstance(b.manifold, EuclideanManifold):
            raise ValueError("bounds require a Euclidean parameter block")
        if b.upper_bound is None:
            b.upper_bound = np.full(b.size, np.inf)
        b.upper_bound[index] = value
        self._dirty = True

    def parameter_block_value(self, block: int) -> np.ndarray:
        return self._blocks[block].values.copy()

    def set_parameter_block_value(self, block: int, values):
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if v.size != self._blocks[block].size:
            raise ValueError("size mismatch")
        self._blocks[block].values = v.copy()
        # Value changes do not require recompiling the program structure.
        if self._program is not None:
            self._program.set_block_value(block, v)

    def remove_parameter_block(self, block: int):
        """Remove a parameter block and every residual block that touches it.

        reference: Problem::RemoveParameterBlock (problem_impl.cc).
        """
        self._blocks[block].removed = True
        self._num_removed_blocks += 1
        for batch in self._batches:
            hits = np.any(batch.param_ids == block, axis=1)
            batch.alive &= ~hits
        self._dirty = True

    # ------------------------------------------------------------------ #
    # residual blocks
    # ------------------------------------------------------------------ #

    def add_residual_block(
        self,
        cost_function: CostFunction,
        loss: Optional[LossFunction],
        params: Sequence[int],
        data: tuple = (),
    ) -> int:
        """Add one residual block; returns its handle.

        reference: Problem::AddResidualBlock (problem.h:268) /
        ProblemCUDA::AddResidualBlock (problem_cuda.h:110-160).
        """
        pid = np.asarray(params, dtype=np.int64).reshape(1, -1)
        stacked = tuple(np.asarray(d)[None, ...] for d in data)
        return int(self.add_residual_blocks(cost_function, loss, pid, stacked)[0])

    def add_residual_blocks(
        self,
        cost_function: CostFunction,
        loss: Optional[LossFunction],
        param_ids,
        data: tuple = (),
    ) -> np.ndarray:
        """Bulk-add n residual blocks sharing one functor: param_ids [n, k],
        data = tuple of [n, ...] arrays. Returns the n handles."""
        if not isinstance(cost_function, CostFunction):
            raise TypeError("cost_function must be a ceres_tpu CostFunction")
        pid = np.asarray(param_ids, dtype=np.int64)
        if pid.ndim != 2:
            raise ValueError("param_ids must be [n, k]")
        n = pid.shape[0]
        for d in data:
            d_n = d.shape[0] if hasattr(d, "gather") else np.asarray(d).shape[0]
            if d_n != n:
                raise ValueError("data arrays must have leading dim n")
        if n and (pid.min() < 0 or pid.max() >= len(self._blocks)):
            bad = pid.reshape(-1)[
                (pid.reshape(-1) < 0) | (pid.reshape(-1) >= len(self._blocks))
            ][0]
            raise ValueError(f"unknown parameter block {bad}")
        if self._num_removed_blocks:
            removed = self._blocks.removed_mask()
            hit = removed[pid]
            if hit.any():
                bad = pid[hit][0]
                raise ValueError(f"unknown parameter block {bad}")
        batch = _ResidualBatch(
            cost_function=cost_function,
            loss=loss,
            param_ids=pid,
            data=tuple(
                d if hasattr(d, "gather") else np.asarray(d) for d in data
            ),
            first_handle=self._next_residual_handle,
            alive=np.ones(n, dtype=bool),
        )
        self._batch_starts.append(self._next_residual_handle)
        self._batches.append(batch)
        handles = np.arange(
            self._next_residual_handle, self._next_residual_handle + n
        )
        self._next_residual_handle += n
        self._dirty = True
        return handles

    def parameter_blocks_for_residual_block(self, handle: int) -> list:
        """Parameter-block handles of one residual block.

        reference: Problem::GetParameterBlocksForResidualBlock
        (problem.h:402)."""
        bi, row = self._locate_handle(handle)
        return [int(b) for b in self._batches[bi].param_ids[row]]

    def residual_blocks_for_parameter_block(self, block: int) -> list:
        """Residual-block handles touching one parameter block.

        reference: Problem::GetResidualBlocksForParameterBlock
        (problem.h:421)."""
        out = []
        for batch in self._batches:
            hits = np.nonzero(
                batch.alive & (batch.param_ids == int(block)).any(axis=1)
            )[0]
            out.extend((batch.first_handle + hits).tolist())
        return out

    def mark_structure_dirty(self):
        """Force recompilation on the next solve — needed after mutating a
        LossFunctionWrapper or other out-of-band structural change."""
        self._dirty = True

    def remove_residual_block(self, handle: int):
        """reference: Problem::RemoveResidualBlock."""
        bi, row = self._locate_handle(handle)
        self._batches[bi].alive[row] = False
        self._dirty = True

    # ------------------------------------------------------------------ #
    # counts (reference: problem.h:468-519)
    # ------------------------------------------------------------------ #

    def num_parameter_blocks(self) -> int:
        return len(self._blocks) - self._blocks.num_removed()

    def num_parameters(self) -> int:
        _rm, _c, sizes, _t, _m, _ms = self._blocks.columns()
        return int(sizes.sum())

    def num_effective_parameters(self) -> int:
        _rm, constant, _s, tsizes, _m, _ms = self._blocks.columns()
        return int(tsizes[~constant].sum())

    def num_residual_blocks(self) -> int:
        return int(sum(batch.alive.sum() for batch in self._batches))

    def num_residuals(self) -> int:
        return int(
            sum(
                batch.alive.sum() * batch.cost_function.num_residuals
                for batch in self._batches
            )
        )

    # ------------------------------------------------------------------ #
    # lowering & evaluation
    # ------------------------------------------------------------------ #

    def compile(self, options=None):
        """Lower to an executable Program (cached until the structure changes)."""
        from .program import Program

        if self._dirty or self._program is None:
            self._program = Program(
                self._blocks, self._batches, self.evaluation_callback
            )
            self._dirty = False
        return self._program

    def residual_rows_for_handles(self, handles) -> np.ndarray:
        """Global residual-row indices (compiled-program row space) of the
        given residual-block handles. Used by the SUBSET preconditioner
        (reference: reorder_program.cc ReorderResidualBlocksByPartition +
        subset_preconditioner_start_row_block — here the rows are addressed
        directly, no reordering needed)."""
        program = self.compile()
        rows = []
        for h in handles:
            bi, row = self._locate_handle(h)
            gi, grow = program.handle_entry(bi, row)
            meta = program.groups[gi]
            r = meta.num_residuals
            start = meta.row_offset + grow * r
            rows.append(np.arange(start, start + r))
        return (
            np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
        )

    def evaluate(
        self,
        apply_loss_function: bool = True,
        residual_blocks: Optional[Sequence[int]] = None,
    ):
        """Whole-problem (or residual-subset) evaluation at the current
        parameter values.

        Returns (cost, residuals, gradient, jacobian) where jacobian is a
        CRS triple. Parity: Problem::Evaluate + EvaluateOptions
        (problem.h:430-467; `residual_blocks` plays the role of
        EvaluateOptions::residual_blocks).
        """
        if residual_blocks is None:
            program = self.compile()
            return program.evaluate_full(apply_loss=apply_loss_function)

        # subset evaluation: lower a filtered program on the fly
        import copy

        from .program import Program

        keep = set(int(h) for h in residual_blocks)
        batches = []
        for bi, batch in enumerate(self._batches):
            nb = copy.copy(batch)
            mask = np.zeros_like(batch.alive)
            for h in keep:
                try:
                    ebi, erow = self._locate_handle(h)
                except KeyError:
                    continue
                if ebi == bi:
                    mask[erow] = True
            nb.alive = batch.alive & mask
            batches.append(nb)
        program = Program(self._blocks, batches, self.evaluation_callback)
        return program.evaluate_full(apply_loss=apply_loss_function)
