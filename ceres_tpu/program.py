"""Program: the lowered, executable form of a Problem.

Counterpart of the reference's Program + preprocess step
(internal/ceres/program.cc, registered_cuda_evaluators.cc:226-280 Init): the
problem is compiled into

- a flat state vector layout (ambient offsets per block; tangent offsets per
  free block, with one trailing "dump" slot absorbing gradient/jacobian
  contributions of constant blocks — the functional replacement for the
  reference's per-block constancy flag checks),
- a Plus structure: one fused index-add for all Euclidean blocks plus vmapped
  batches per non-Euclidean manifold class (reference: Program::Plus,
  program.cc; ParameterBlockCUDA plus-Jacobian upload,
  registered_cuda_evaluators.cc:105-121),
- signature groups: residual blocks bucketed by (functor, residual size,
  param sizes, manifolds, loss) with gather/scatter index tables — the analog
  of the reference's per-type CUDA evaluators keyed by std::type_index
  (problem_cuda.h:462-468), which simultaneously solves XLA's static-shape
  requirement.

All index tables are numpy on the host; `arrays()` materializes the jnp
pytree consumed by the jitted evaluator (evaluator.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from .autodiff import CostFunction
from .utils.flags import env_flag

def _data_shape_dtype(d):
    """(trailing shape, dtype str) of a residual-data leaf without
    materializing it (io.lazy.LazyRows exposes shape/dtype directly)."""
    if hasattr(d, "gather") and hasattr(d, "shape"):
        return (tuple(d.shape[1:]), np.dtype(d.dtype).str)
    a = np.asarray(d)
    return (a.shape[1:], a.dtype.str)

from .loss import LossFunction
from .manifolds import EuclideanManifold, Manifold


def _span_indices(starts, lens):
    """Concatenate [start_i, start_i + len_i) ranges into one index vector
    without a Python loop: the vectorized form of
    concat([arange(s, s+l) for s, l in zip(starts, lens)])."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    # offset-within-span via a running reset at each span boundary
    ends = np.cumsum(lens)
    idx = np.arange(total, dtype=np.int64)
    span_of = np.searchsorted(ends, idx, side="right")
    within = idx - (ends - lens)[span_of]
    return starts[span_of] + within


@dataclasses.dataclass(frozen=True)
class PositionMeta:
    """Static description of one parameter slot of a signature."""

    size: int
    tangent_size: int
    manifold: Optional[Manifold]  # None == Euclidean
    a_cls: int = -1  # ambient class id (gathers)
    t_cls: int = -1  # tangent class id (scatters); -1 if no free block has it


@dataclasses.dataclass
class SigGroupMeta:
    """Static description of one signature group."""

    cost_function: CostFunction
    loss: Optional[LossFunction]
    positions: tuple
    n: int
    row_offset: int
    # {position: plan} where plan is one of
    #   ("bucket", buckets): rows laid out in the interleaved bucket order of
    #       this position's class rows — gathers become slice+broadcast and
    #       reductions become reshape+sum (no gather/scatter at all). buckets
    #       is a tuple of (lane_start, n_seg, degree, out_row): lanes
    #       [lane_start + j*n_seg + e] hold observation j of class row
    #       out_row + e.
    #   ("onehot",): reduction as a one-hot matmul (small class).
    #   ("segsum",): generic segment-sum / take fallback.
    red_plans: Optional[dict] = None
    # position that owns the row ordering (has the "bucket" plan), or -1
    owner: int = -1
    # True when the owner position's ambient class rows equal its tangent
    # class rows (so state gathers can use the bucket plan too)
    owner_ambient_aligned: bool = False
    # shard-local plans published by parallel.sharding.build_sharded_arrays
    # (see Program.build_shard_layout): {pos: ("bucket_sharded", buckets)}
    shard_red_plans: Optional[dict] = None
    shard_ndev: int = 0

    @property
    def num_residuals(self) -> int:
        return self.cost_function.num_residuals

    @property
    def rows(self) -> int:
        return self.n * self.num_residuals


@dataclasses.dataclass
class ManifoldGroupMeta:
    manifold: Manifold
    n: int


class Program:
    """Executable lowering of a Problem. See module docstring."""

    # groups at least this large get the scatter-free bucketed reduction
    SEG_REDUCE_THRESHOLD = 32_768
    MAX_SEG_BUCKETS = 512
    # max one-hot matmul width for small-class reductions (cost is
    # k * cnt * n MACs, lane-chunked so memory stays bounded). Covers
    # BAL-13682's camera class. On the H100 take/segment_sum measure ~10x
    # faster (PERF.md); choosing the plan by backend is a ROADMAP item.
    ONEHOT_MAX_COLS = 16384

    def __init__(self, blocks, batches, evaluation_callback=None):
        self._blocks = blocks
        self._batches = batches
        self.evaluation_callback = evaluation_callback
        self._compute_block_degrees()
        self._build_layout()
        self._build_plus_structure()
        self._build_classes()
        self._build_groups()
        self._evaluator = None

    def _compute_block_degrees(self):
        """Residual-row count per parameter block (its 'degree').

        Tangent classes are laid out in (degree, id) order so that rows of a
        large signature group, sorted by the designated reduce position's
        class row, form contiguous equal-degree runs — making J^T-side
        reductions pure reshape+sum (see _build_groups seg_reduce): no
        scatter, and bitwise-deterministic sums.
        """
        nb = len(self._blocks)
        deg = np.zeros(nb, dtype=np.int64)
        for batch in self._batches:
            rows = batch.param_ids[batch.alive]
            if rows.size:
                np.add.at(deg, rows.reshape(-1), 1)
        self.block_degree = deg

    def _build_classes(self):
        """Aliases over the class-contiguous layout tables (see
        _build_layout). Per-class [count, s] views of the tangent/state
        vectors are plain reshapes; block-diagonal JtJ (Jacobi /
        Schur-Jacobi, (EtE)^-1) becomes one batched segment-sum + Cholesky
        per class (reference: block_jacobi_preconditioner.cc)."""
        self.class_tsizes = list(self.tangent_class_sizes)
        self.class_counts = list(self.tangent_class_counts)
        self.class_of_tsize = dict(self.tangent_class_of_size)
        self.block_class = self.t_class
        self.block_class_index = self.t_row
        # affine per-class tangent offsets (kept for export/debug paths)
        self.class_t_offsets = [
            (
                self.tangent_class_bases[c]
                + np.arange(self.class_counts[c]) * self.class_tsizes[c]
            ).astype(np.int32)
            for c in range(len(self.class_tsizes))
        ]

    def tangent_class_slice(self, cls: int):
        """(base, count, size) of a tangent class within the flat tangent
        vector: v[base : base + count*size].reshape(count, size)."""
        return (
            int(self.tangent_class_bases[cls]),
            int(self.tangent_class_counts[cls]),
            int(self.tangent_class_sizes[cls]),
        )

    def ambient_class_slice(self, cls: int):
        return (
            int(self.ambient_class_bases[cls]),
            int(self.ambient_class_counts[cls]),
            int(self.ambient_class_sizes[cls]),
        )

    # ------------------------------------------------------------------ #
    # layout
    # ------------------------------------------------------------------ #

    @staticmethod
    def _span_indices(starts, lens):
        return _span_indices(starts, lens)

    def _collect_block_arrays(self):
        """Per-block metadata columns, via the block store's vectorized
        path when available (problem.py _BlockStore.columns — no
        per-object Python work at BA scale) or a generic object pass."""
        blocks = self._blocks
        if hasattr(blocks, "columns"):
            removed, constant, sizes, tsizes, manifold_ids, manifolds = (
                blocks.columns()
            )
        else:
            nb = len(blocks)
            removed = np.zeros(nb, dtype=bool)
            constant = np.zeros(nb, dtype=bool)
            sizes = np.zeros(nb, dtype=np.int64)
            tsizes = np.zeros(nb, dtype=np.int64)
            manifold_ids = np.full(nb, -1, dtype=np.int64)
            manifolds = []
            manifold_index: dict = {}
            for b in blocks:
                i = b.index
                removed[i] = b.removed
                if b.removed:
                    continue
                constant[i] = b.constant
                sizes[i] = b.size
                m = b.manifold
                if m is None or isinstance(m, EuclideanManifold):
                    tsizes[i] = sizes[i]
                else:
                    tsizes[i] = m.tangent_size
                    mid = manifold_index.get(m)
                    if mid is None:
                        mid = len(manifolds)
                        manifold_index[m] = mid
                        manifolds.append(m)
                    manifold_ids[i] = mid
        self._col_removed = removed
        self._col_constant = constant
        self._col_manifold_ids = manifold_ids
        self._manifold_objects = manifolds
        return removed, constant, sizes, tsizes, manifold_ids

    def _build_layout(self):
        """Class-contiguous layout: blocks are grouped by ambient size in the
        state vector and by tangent size in the tangent vector, so every
        gather/scatter in the hot path is a ROW operation on a dense
        [count, size] table (jnp.take / segment_sum) instead of element
        gathers."""
        blocks = self._blocks
        nb = len(blocks)
        removed, constant, sizes, tsizes, _ = self._collect_block_arrays()
        self.sizes = sizes
        self.tangent_sizes = tsizes
        live = ~removed
        free = live & ~constant

        # tangent classes first: key = tangent size, over free blocks
        self.tangent_class_sizes = sorted(set(tsizes[free].tolist()))
        self.tangent_class_of_size = {
            s: i for i, s in enumerate(self.tangent_class_sizes)
        }
        t_size_keys = np.asarray(self.tangent_class_sizes, dtype=np.int64)
        self.t_class = np.full(nb, -1, dtype=np.int64)
        if t_size_keys.size:
            self.t_class[free] = np.searchsorted(t_size_keys, tsizes[free])
        # class rows assigned in (degree, id) order — see
        # _compute_block_degrees. Vectorized rank-within-class.
        self.t_row = np.full(nb, -1, dtype=np.int64)
        free_ids = np.nonzero(free)[0]
        order = free_ids[
            np.lexsort((free_ids, self.block_degree[free_ids]))
        ]  # sorted by (degree, id)
        cls_of_order = self.t_class[order]
        t_counts = [int(np.sum(cls_of_order == c)) for c in range(t_size_keys.size)]
        # rank within class along the (degree, id) order
        rank = np.empty(order.size, dtype=np.int64)
        csort = np.argsort(cls_of_order, kind="stable")
        pos = np.empty(order.size, dtype=np.int64)
        pos[csort] = np.arange(order.size)
        bases = np.concatenate([[0], np.cumsum(t_counts)])
        rank = pos - bases[cls_of_order]
        self.t_row[order] = rank
        self.tangent_class_counts = t_counts

        # ambient classes: key = ambient size, over all live blocks. Where an
        # ambient class consists entirely of free blocks of one tangent
        # class, its rows are ALIGNED to the tangent class rows so the same
        # bucket layout serves state gathers and tangent reductions.
        self.ambient_class_sizes = sorted(set(sizes[live].tolist()))
        self.ambient_class_of_size = {
            s: i for i, s in enumerate(self.ambient_class_sizes)
        }
        a_size_keys = np.asarray(self.ambient_class_sizes, dtype=np.int64)
        self.a_class = np.full(nb, -1, dtype=np.int64)
        if a_size_keys.size:
            self.a_class[live] = np.searchsorted(a_size_keys, sizes[live])
        self.a_row = np.full(nb, -1, dtype=np.int64)
        a_counts = [
            int(np.sum(self.a_class[live] == c))
            for c in range(a_size_keys.size)
        ]
        self.ambient_aligned = [False] * len(self.ambient_class_sizes)
        for c in range(a_size_keys.size):
            members = np.nonzero(live & (self.a_class == c))[0]
            t_cls = np.unique(self.t_class[members])
            if (
                members.size
                and t_cls.size == 1
                and t_cls[0] >= 0
                # bijection: the tangent class must consist of exactly this
                # ambient class's blocks (another ambient class could share
                # the same tangent size, e.g. via a manifold)
                and self.tangent_class_counts[int(t_cls[0])] == members.size
            ):
                self.ambient_aligned[c] = True
                self.a_row[members] = self.t_row[members]
            else:
                self.a_row[members] = np.arange(members.size)
        self.ambient_class_counts = a_counts
        self.ambient_class_bases = np.concatenate(
            [[0], np.cumsum([c * s for c, s in zip(a_counts, self.ambient_class_sizes)])]
        ).astype(np.int64)
        self.x_offsets = np.zeros(nb, dtype=np.int64)
        self.x_offsets[live] = (
            self.ambient_class_bases[self.a_class[live]]
            + self.a_row[live] * sizes[live]
        )
        self.num_parameters = int(self.ambient_class_bases[-1])
        self.tangent_class_bases = np.concatenate(
            [[0], np.cumsum([c * s for c, s in zip(t_counts, self.tangent_class_sizes)])]
        ).astype(np.int64)
        self.t_offsets = np.full(nb, -1, dtype=np.int64)
        self.t_offsets[free] = (
            self.tangent_class_bases[self.t_class[free]]
            + self.t_row[free] * tsizes[free]
        )
        self.num_effective_parameters = int(self.tangent_class_bases[-1])

        self.state0 = np.zeros(self.num_parameters, dtype=np.float64)
        if hasattr(blocks, "fill_state"):
            blocks.fill_state(self.state0, self.x_offsets)
        else:
            for b in blocks:
                if not b.removed:
                    o = self.x_offsets[b.index]
                    self.state0[o : o + b.size] = b.values

        # bounds (reference: ParameterBlock bounds clamping,
        # parameter_block.h PlusWithBoundsClamping)
        if hasattr(blocks, "bounds_any"):
            self.has_bounds = blocks.bounds_any()
        else:
            self.has_bounds = any(
                (b.lower_bound is not None or b.upper_bound is not None)
                for b in blocks
                if not b.removed
            )
        if self.has_bounds:
            self.lower_bound = np.full(self.num_parameters, -np.inf)
            self.upper_bound = np.full(self.num_parameters, np.inf)
            if hasattr(blocks, "fill_bounds"):
                blocks.fill_bounds(
                    self.lower_bound, self.upper_bound, self.x_offsets
                )
                _skip_bounds_loop = True
            else:
                _skip_bounds_loop = False
            for b in (() if _skip_bounds_loop else blocks):
                if b.removed:
                    continue
                o = self.x_offsets[b.index]
                if b.lower_bound is not None:
                    self.lower_bound[o : o + b.size] = b.lower_bound
                if b.upper_bound is not None:
                    self.upper_bound[o : o + b.size] = b.upper_bound
        else:
            self.lower_bound = None
            self.upper_bound = None

    def bound_coordinate_maps(self):
        """(tangent_idx, ambient_idx) int arrays pairing each tangent
        coordinate of a free Euclidean block with its ambient state slot.
        Used for active-set masking of bound-constrained coordinates (blocks
        with non-trivial manifolds have no coordinate-wise pairing and are
        excluded; the projection in Plus still clamps them)."""
        if getattr(self, "_bound_maps", None) is not None:
            return self._bound_maps
        sel = np.nonzero(
            (~self._col_removed)
            & (~self._col_constant)
            & (self._col_manifold_ids < 0)  # Euclidean/None only
            & (self.t_offsets >= 0)
        )[0]
        if sel.size:
            self._bound_maps = (
                _span_indices(self.t_offsets[sel], self.sizes[sel]),
                _span_indices(self.x_offsets[sel], self.sizes[sel]),
            )
        else:
            self._bound_maps = (
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64),
            )
        return self._bound_maps

    # ------------------------------------------------------------------ #
    # Plus structure
    # ------------------------------------------------------------------ #

    def _build_plus_structure(self):
        """Row-based Plus: per ambient class, Euclidean free blocks add
        their delta rows (row gather from the tangent class table, constants
        map to a zero dump row); manifold blocks are batched per manifold
        and their rows overwritten (reference: Program::Plus, program.cc).
        Fully vectorized over the collected block columns."""
        removed = self._col_removed
        constant = self._col_constant
        mids = self._col_manifold_ids
        free = ~removed & ~constant
        euclid = free & (mids < 0)

        self.plus_euclid = []  # list over ambient classes: dict | None
        for a_c, cnt in enumerate(self.ambient_class_counts):
            sel = euclid & (self.a_class == a_c)
            if not sel.any():
                self.plus_euclid.append(None)
                continue
            size = self.ambient_class_sizes[a_c]
            t_cls = self.tangent_class_of_size[size]
            dump = self.tangent_class_counts[t_cls]
            rows = np.full(cnt, dump, dtype=np.int64)
            rows[self.a_row[sel]] = self.t_row[sel]
            self.plus_euclid.append(
                {"t_cls": t_cls, "t_row_map": rows.astype(np.int32)}
            )

        self.manifold_group_meta: list[ManifoldGroupMeta] = []
        self.manifold_group_idx: list[dict] = []
        for mid, m in enumerate(self._manifold_objects):
            idx = np.nonzero(free & (mids == mid))[0]
            if idx.size == 0:
                continue
            self.manifold_group_meta.append(ManifoldGroupMeta(m, int(idx.size)))
            self.manifold_group_idx.append(
                {
                    "a_cls": int(self.a_class[idx[0]]),
                    "t_cls": int(self.t_class[idx[0]]),
                    "a_rows": self.a_row[idx].astype(np.int32),
                    "t_rows": self.t_row[idx].astype(np.int32),
                }
            )

    # ------------------------------------------------------------------ #
    # signature groups
    # ------------------------------------------------------------------ #

    def _sig_key(self, batch):
        cf = batch.cost_function
        sizes = tuple(int(self.sizes[b]) for b in batch.param_ids[0])
        manifolds = tuple(
            None
            if (
                self._blocks[b].manifold is None
                or isinstance(self._blocks[b].manifold, EuclideanManifold)
            )
            else self._blocks[b].manifold
            for b in batch.param_ids[0]
        )
        data_sig = tuple(_data_shape_dtype(d) for d in batch.data)
        return (cf.fn, cf.num_residuals, batch.loss, sizes, manifolds, data_sig)

    def _build_groups(self):
        # Bucket batches by signature. Within a batch all rows share one
        # signature *only if* every row's parameter blocks have identical
        # (size, manifold) tuples — enforced here by keying on row 0 and
        # verifying uniformity.
        buckets: dict = {}
        order: list = []
        # per-batch (group_idx array, group_row array) indexed by batch row
        self._handle_arrays: dict = {}

        for bi, batch in enumerate(self._batches):
            if batch.alive.all():
                # fast path: rows=None means "all rows" (no index copies)
                alive_rows = None
                first = 0
            else:
                alive_rows = np.nonzero(batch.alive)[0]
                if alive_rows.size == 0:
                    continue
                first = alive_rows[0]
            sizes0 = self.sizes[batch.param_ids[first]]
            rows_pid = (
                batch.param_ids if alive_rows is None
                else batch.param_ids[alive_rows]
            )
            if not np.all(self.sizes[rows_pid] == sizes0):
                raise ValueError(
                    "all rows of a residual batch must have uniform block sizes"
                )
            key = self._sig_key_for_row(batch, first)
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append((bi, alive_rows))

        self.groups: list[SigGroupMeta] = []
        self.group_idx: list[dict] = []
        row_offset = 0
        for gi, key in enumerate(order):
            members = buckets[key]
            bi0, rows0 = members[0]
            batch0 = self._batches[bi0]
            k = batch0.param_ids.shape[1]

            def _take(arr, rows):
                return arr if rows is None else arr[rows]

            def _take_data(d, rows):
                # LazyRows: keep lazy (rows=None is identity); ndarray: copy
                if hasattr(d, "gather"):
                    return d if rows is None else d[rows]
                return _take(np.asarray(d), rows)

            if len(members) == 1:
                bi, rows = members[0]
                pid = _take(self._batches[bi].param_ids, rows)
                data = tuple(
                    _take_data(d, rows) for d in self._batches[bi].data
                )
            else:
                pid = np.concatenate(
                    [_take(self._batches[bi].param_ids, rows) for bi, rows in members]
                )
                data = tuple(
                    np.concatenate(
                        [
                            np.asarray(
                                _take_data(self._batches[bi].data[di], rows)
                            )
                            for bi, rows in members
                        ]
                    )
                    for di in range(len(batch0.data))
                )
            n = pid.shape[0]

            positions = []
            for pos in range(k):
                b0 = self._blocks[pid[0, pos]]
                size = int(self.sizes[pid[0, pos]])
                manifold = (
                    None
                    if (
                        b0.manifold is None
                        or isinstance(b0.manifold, EuclideanManifold)
                    )
                    else b0.manifold
                )
                tsize = manifold.tangent_size if manifold is not None else size
                a_cls = self.ambient_class_of_size[size]
                t_cls = self.tangent_class_of_size.get(tsize, -1)
                positions.append(
                    PositionMeta(size, tsize, manifold, a_cls, t_cls)
                )

            meta = SigGroupMeta(
                cost_function=batch0.cost_function,
                loss=batch0.loss,
                positions=tuple(positions),
                n=n,
                row_offset=row_offset,
            )

            # ---- gather/scatter-free layout plans (large groups) ----
            # The position with the largest class ("owner", e.g. BA points)
            # dictates the row order: rows sorted by its class row, then
            # INTERLEAVED within each equal-degree bucket so that observation
            # j of class row (out_row + e) sits at lane (lane_start +
            # j*n_seg + e). In the transposed [k, n] layout this makes the
            # owner's gathers a slice+broadcast and its reductions a
            # reshape+sum over the second-minor axis — no gather/scatter.
            # Small classes (e.g. BA cameras) reduce via a one-hot matmul.
            # Everything else falls back to segment_sum.
            perm = None
            plans: dict = {}
            owner = -1
            if n >= self.SEG_REDUCE_THRESHOLD:
                candidates = [
                    (self.tangent_class_counts[pm.t_cls], pos)
                    for pos, pm in enumerate(positions)
                    if pm.t_cls >= 0
                    and np.all(self.t_row[pid[:, pos]] >= 0)  # all free
                ]
                if candidates:
                    _, rpos = max(candidates)
                    rows_of = self.t_row[pid[:, rpos]]
                    perm = np.argsort(rows_of, kind="stable")
                    buckets = self._seg_buckets(rows_of[perm])
                    if buckets is not None:
                        ileave = np.empty(n, dtype=np.int64)
                        for (lane_start, n_seg, d, _out) in buckets:
                            blockidx = np.arange(
                                lane_start, lane_start + n_seg * d
                            ).reshape(n_seg, d)
                            ileave[lane_start : lane_start + n_seg * d] = (
                                blockidx.T.reshape(-1)
                            )
                        perm = perm[ileave]
                        owner = rpos
                        plans[rpos] = ("bucket", buckets)
                    pid = pid[perm]
                    data = tuple(d[perm] for d in data)
                for pos, pm in enumerate(positions):
                    if pos in plans or pm.t_cls < 0:
                        continue
                    cnt = self.tangent_class_counts[pm.t_cls]
                    # XLA-CPU materializes the one-hot operand — [5M, 1779]
                    # f64 is 71 GB — so CPU-bound full-scale runs (e.g. an
                    # f64 reference on the host) disable it via env.
                    if cnt + 1 <= self.ONEHOT_MAX_COLS and not env_flag(
                        "CERES_TPU_NO_ONEHOT"
                    ):
                        plans[pos] = ("onehot",)

            # per-position row tables, built AFTER the layout permutation so
            # the permutation touches only pid/data (not six index arrays)
            a_rows, t_rows, block_ids = [], [], []
            for pos, pm in enumerate(positions):
                ids = pid[:, pos]
                a_rows.append(self.a_row[ids].astype(np.int32))
                # constant blocks scatter into the per-class dump row (=count)
                tr = self.t_row[ids]
                dump = (
                    self.tangent_class_counts[pm.t_cls] if pm.t_cls >= 0 else 0
                )
                t_rows.append(np.where(tr >= 0, tr, dump).astype(np.int32))
                block_ids.append(ids.astype(np.int32))
            meta.red_plans = plans
            meta.owner = owner
            if owner >= 0:
                meta.owner_ambient_aligned = bool(
                    np.array_equal(a_rows[owner], t_rows[owner])
                )
            self.groups.append(meta)
            self.group_idx.append(
                {
                    "a_rows": tuple(a_rows),
                    "t_rows": tuple(t_rows),
                    "block_ids": tuple(block_ids),
                    "data": data,
                }
            )

            # handle bookkeeping (accounting for the layout row perm),
            # vectorized: per-batch arrays mapping batch row -> group row
            inv = None
            if perm is not None:
                inv = np.empty_like(perm)
                inv[perm] = np.arange(len(perm))
            grow = 0
            for bi, rows in members:
                nrows_b = self._batches[bi].param_ids.shape[0]
                m = nrows_b if rows is None else len(rows)
                dest = np.arange(grow, grow + m)
                if inv is not None:
                    dest = inv[dest]
                if bi not in self._handle_arrays:
                    self._handle_arrays[bi] = (
                        np.full(nrows_b, -1, dtype=np.int64),
                        np.full(nrows_b, -1, dtype=np.int64),
                    )
                gi_arr, grow_arr = self._handle_arrays[bi]
                rows_idx = slice(None) if rows is None else rows
                gi_arr[rows_idx] = gi
                grow_arr[rows_idx] = dest
                grow += m

            row_offset += meta.rows

        self.num_residuals = row_offset
        self.num_residual_blocks = sum(g.n for g in self.groups)

    def build_shard_layout(self, ndev: int):
        """Shard-aware row layout: per group, a permutation into shard-major
        lanes where each shard's local slice follows its OWN interleaved
        bucket order, so the scatter-free bucket plans survive sharding
        (otherwise multi-device reductions fall back to segment_sum).

        For each owner bucket (n_seg entities of degree d), entities split
        into ndev contiguous runs of per_e = ceil(n_seg/ndev); shard s owns
        class rows [out_row + s*per_e, ...), its local lanes are
        (local_start + j*per_e + e), and trailing shards carry masked pad
        lanes. Groups without an owner bucket plan keep their order and pad
        at the end.

        Returns {gi: dict(perm, lanes_per_shard, shard_buckets)} where perm
        maps new global lane -> original group row (-1 = pad) and
        shard_buckets is a tuple of (local_lane_start, per_e, d, out_row)
        interpreted with column offset out_row + axis_index*per_e.
        Cached per ndev.
        """
        cache = getattr(self, "_shard_layouts", None)
        if cache is None:
            cache = self._shard_layouts = {}
        if ndev in cache:
            return cache[ndev]
        layouts = {}
        for gi, meta in enumerate(self.groups):
            n = meta.n
            plan = (meta.red_plans or {}).get(meta.owner)
            if plan is None or plan[0] != "bucket":
                per = -(-n // ndev)
                L = per
                perm = np.full(L * ndev, -1, dtype=np.int64)
                perm[:n] = np.arange(n)
                layouts[gi] = dict(
                    perm=perm, lanes_per_shard=L, shard_buckets=None
                )
                continue
            buckets = plan[1]
            # per-shard bucket table + local lane count
            shard_buckets = []
            local_start = 0
            for (lane_start, n_seg, d, out_row) in buckets:
                per_e = -(-n_seg // ndev)
                shard_buckets.append((local_start, per_e, d, out_row))
                local_start += per_e * d
            L = local_start
            perm = np.full(L * ndev, -1, dtype=np.int64)
            for (lane_start, n_seg, d, out_row), (
                ls,
                per_e,
                _d,
                _o,
            ) in zip(buckets, shard_buckets):
                # original lanes of this bucket: lane_start + j*n_seg + e
                for s in range(ndev):
                    e0 = s * per_e
                    e1 = min(e0 + per_e, n_seg)
                    cnt_e = e1 - e0
                    if cnt_e <= 0:
                        continue
                    # new lanes: s*L + ls + j*per_e + (e - e0)
                    j = np.arange(d)[:, None]
                    e = np.arange(e0, e1)[None, :]
                    src = lane_start + j * n_seg + e
                    dst = s * L + ls + j * per_e + (e - e0)
                    perm[dst.reshape(-1)] = src.reshape(-1)
            layouts[gi] = dict(
                perm=perm, lanes_per_shard=L, shard_buckets=tuple(shard_buckets)
            )
        cache[ndev] = layouts
        return layouts

    def handle_entry(self, bi: int, row: int):
        """(group_idx, group_row) of a residual block by (batch, batch-row)."""
        gi_arr, grow_arr = self._handle_arrays[bi]
        return int(gi_arr[row]), int(grow_arr[row])

    def _seg_buckets(self, sorted_rows: np.ndarray):
        """Bucket decomposition of a class-row-sorted row array.

        Returns tuple of (lane_start, n_seg, degree, out_row_start) covering
        all rows, where each bucket is n_seg consecutive class rows (starting
        at out_row_start) each with exactly `degree` rows. With the
        interleaved lane order (see _build_groups) the reduction over a
        bucket is reshape(k, degree, n_seg).sum(1) written at column
        out_row_start. Returns None when the decomposition fragments
        (> MAX_SEG_BUCKETS).
        """
        uniq, starts, counts = np.unique(
            sorted_rows, return_index=True, return_counts=True
        )
        buckets = []
        i = 0
        m = len(uniq)
        while i < m:
            j = i + 1
            # extend run: consecutive class rows with equal degree
            while (
                j < m
                and counts[j] == counts[i]
                and uniq[j] == uniq[j - 1] + 1
            ):
                j += 1
            buckets.append((int(starts[i]), j - i, int(counts[i]), int(uniq[i])))
            i = j
        if len(buckets) > self.MAX_SEG_BUCKETS:
            return None
        return tuple(buckets)

    def _sig_key_for_row(self, batch, row):
        cf = batch.cost_function
        sizes = tuple(int(self.sizes[b]) for b in batch.param_ids[row])
        manifolds = tuple(
            None
            if (
                self._blocks[b].manifold is None
                or isinstance(self._blocks[b].manifold, EuclideanManifold)
            )
            else self._blocks[b].manifold
            for b in batch.param_ids[row]
        )
        data_sig = tuple(_data_shape_dtype(d) for d in batch.data)
        return (cf.fn, cf.num_residuals, batch.loss, sizes, manifolds, data_sig)

    # ------------------------------------------------------------------ #
    # Schur elimination partition
    # ------------------------------------------------------------------ #

    def compute_schur_partition(self, user_e_override=None, cache=True):
        """Classify free parameter blocks into e-blocks (eliminated, e.g. BA
        points) and f-blocks (kept, e.g. cameras).

        user_e_override: optional explicit eliminated-block handle set that
        bypasses both the cache and `_user_e_blocks` (used by the inner
        iteration minimizer's own ordering, reference
        inner_iteration_ordering / coordinate_descent_minimizer.cc:88-150).

        Replacement of the reference's greedy maximal independent
        set ordering (parameter_block_ordering.cc:used via
        graph_algorithms.h IndependentSetOrdering): each residual row elects
        the lowest-degree block it touches as its winner; a block is an
        e-candidate iff it wins every row it appears in — which yields an
        independent set in one vectorized pass. Group positions with mixed
        e/f membership are demoted until every retained e-position is pure,
        so the partition maps onto whole signature-group positions (the unit
        of batched evaluation).

        Returns (e_mask_blocks [nb] bool, e_positions, f_positions) where
        e/f_positions are lists over groups of position-index tuples.
        Caches the result.
        """
        if (
            user_e_override is None
            and cache
            and getattr(self, "_schur_partition", None) is not None
        ):
            return self._schur_partition

        nb = len(self._blocks)
        degree = np.zeros(nb, dtype=np.int64)
        rows_count = np.zeros(nb, dtype=np.int64)
        for gi, idx in enumerate(self.group_idx):
            for ids in idx["block_ids"]:
                np.add.at(degree, ids, 1)
        # winner of each row: free block with min (degree, id)
        wins = np.zeros(nb, dtype=np.int64)
        for gi, idx in enumerate(self.group_idx):
            ids_mat = np.stack(idx["block_ids"], axis=1)  # [n, k]
            free = self.t_offsets[ids_mat] >= 0
            key = degree[ids_mat] * (nb + 1) + ids_mat
            key = np.where(free, key, np.iinfo(np.int64).max)
            has_free = free.any(axis=1)
            winner = ids_mat[np.arange(ids_mat.shape[0]), np.argmin(key, axis=1)]
            np.add.at(wins, winner[has_free], 1)
            for pos in range(ids_mat.shape[1]):
                np.add.at(rows_count, ids_mat[:, pos], 1)

        user_e = (
            user_e_override
            if user_e_override is not None
            else getattr(self, "_user_e_blocks", None)
        )
        if user_e is not None:
            # user-specified elimination group (reference:
            # Solver::Options::linear_solver_ordering group 0,
            # reorder_program.cc). Must be an independent set: no residual
            # row may touch two eliminated blocks.
            e_mask = np.zeros(nb, dtype=bool)
            sel = np.asarray(list(user_e), dtype=np.int64)
            e_mask[sel] = True
            e_mask &= self.t_offsets >= 0
            for gi, idx in enumerate(self.group_idx):
                ids_mat = np.stack(idx["block_ids"], axis=1)
                if int(e_mask[ids_mat].sum(axis=1).max(initial=0)) > 1:
                    raise ValueError(
                        "linear_solver_ordering group 0 is not an "
                        "independent set: a residual block touches two "
                        "eliminated parameter blocks"
                    )
        else:
            e_mask = (
                (wins == rows_count) & (rows_count > 0) & (self.t_offsets >= 0)
            )

        # demote until every group position is uniformly e or f, and at most
        # one e-position per group (each residual row may touch only one
        # eliminated block — the Schur chunk invariant,
        # schur_eliminator.h:167-380).
        changed = True
        while changed:
            changed = False
            for gi, idx in enumerate(self.group_idx):
                e_positions = []
                for pos, ids in enumerate(idx["block_ids"]):
                    flags = e_mask[ids]
                    if flags.any() and not flags.all():
                        e_mask[ids[flags]] = False
                        changed = True
                    elif flags.all() and flags.size:
                        e_positions.append(pos)
                if len(e_positions) > 1:
                    for pos in e_positions[1:]:
                        e_mask[idx["block_ids"][pos]] = False
                    changed = True

        e_positions, f_positions = [], []
        for gi, idx in enumerate(self.group_idx):
            eps, fps = [], []
            for pos, ids in enumerate(idx["block_ids"]):
                if ids.size and e_mask[ids].all() and e_mask[ids].any():
                    eps.append(pos)
                else:
                    fps.append(pos)
            e_positions.append(tuple(eps))
            f_positions.append(tuple(fps))

        result = (e_mask, e_positions, f_positions)
        if user_e_override is None and cache:
            self._schur_partition = result
        return result

    def schur_tangent_masks(self):
        """(e_mask, f_mask) over the tangent vector [num_eff]."""
        e_blocks, _, _ = self.compute_schur_partition()
        e = np.zeros(self.num_effective_parameters, dtype=np.float64)
        sel = np.nonzero(np.asarray(e_blocks) & (self.t_offsets >= 0))[0]
        if sel.size:
            e[_span_indices(self.t_offsets[sel], self.tangent_sizes[sel])] = 1.0
        return e, 1.0 - e

    # ------------------------------------------------------------------ #
    # runtime arrays
    # ------------------------------------------------------------------ #

    def arrays(self, dtype=None):
        """Materialize the jnp pytree consumed by the evaluator."""
        import jax.numpy as jnp

        from .utils.dtypes import default_dtype

        dtype = dtype or default_dtype()
        groups = []
        for meta, idx in zip(self.groups, self.group_idx):
            g = {
                "a_rows": tuple(jnp.asarray(a) for a in idx["a_rows"]),
                "t_rows": tuple(jnp.asarray(t) for t in idx["t_rows"]),
                "data": tuple(
                    jnp.asarray(
                        np.asarray(d),
                        dtype=dtype
                        if np.issubdtype(np.dtype(_data_shape_dtype(d)[1]), np.floating)
                        else None,
                    )
                    for d in idx["data"]
                ),
            }
            groups.append(g)
        arrays = {
            "groups": groups,
            "plus_euclid": [
                None if rec is None else {"t_row_map": jnp.asarray(rec["t_row_map"])}
                for rec in self.plus_euclid
            ],
            "manifold_groups": [
                {
                    "a_rows": jnp.asarray(g["a_rows"]),
                    "t_rows": jnp.asarray(g["t_rows"]),
                }
                for g in self.manifold_group_idx
            ],
        }
        if self.has_bounds:
            arrays["lower_bound"] = jnp.asarray(self.lower_bound, dtype=dtype)
            arrays["upper_bound"] = jnp.asarray(self.upper_bound, dtype=dtype)
        return arrays

    def state_vector(self, dtype=None):
        import jax.numpy as jnp

        from .utils.dtypes import default_dtype

        return jnp.asarray(self.state0, dtype=dtype or default_dtype())

    def set_block_value(self, block: int, values: np.ndarray):
        o = int(self.x_offsets[block])
        self.state0[o : o + len(values)] = values

    def write_state_back(self, state, blocks=None):
        """Copy a solved state vector back into the Problem's blocks."""
        state = np.asarray(state, dtype=np.float64)
        self.state0 = state.copy()
        if hasattr(self._blocks, "write_back"):
            self._blocks.write_back(state, self.x_offsets)
            return
        for b in self._blocks:
            if b.removed:
                continue
            o = int(self.x_offsets[b.index])
            b.values[:] = state[o : o + b.size]

    # ------------------------------------------------------------------ #
    # evaluation entry points
    # ------------------------------------------------------------------ #

    def evaluator(self):
        if self._evaluator is None:
            from .evaluator import Evaluator

            self._evaluator = Evaluator(self)
        return self._evaluator

    def evaluate_full(self, apply_loss: bool = True):
        """(cost, residuals, gradient, jacobian-CRS) at the current state.

        Parity: Problem::Evaluate (problem.h:430). The Jacobian columns are
        tangent-space coordinates of the free parameter blocks.
        """
        ev = self.evaluator()
        state = self.state_vector()
        cost, res, jac, grad = ev.evaluate(state, apply_loss=apply_loss)
        crs = jac.to_crs() if jac is not None else None
        return float(cost), np.asarray(res), np.asarray(grad), crs
