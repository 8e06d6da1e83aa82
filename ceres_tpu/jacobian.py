"""BlockJacobian: the matrix-free Jacobian operator in transposed SoA layout.

Replacement for the reference's materialized sparse Jacobians
(BlockSparseMatrix, block_sparse_matrix.cc; CompressedRowSparseMatrix) and
their CUDA views. Every per-observation tensor lives TRANSPOSED, minor
axis = observation: residuals are [r, n], the Jacobian block of one
signature position is [r*t, n]. All products

    J v, J^T u, J^T J v, column norms, per-block Gram blocks

are python-unrolled elementwise ops over [*, n] slices that XLA fuses into
single passes over the observation axis, and the gather/scatter problem is
solved by layout:

- the "owner" position (largest class, e.g. BA points) has its rows in the
  interleaved bucket order (program.py red_plans): gathers become
  slice + broadcast and reductions become reshape + sum — zero gathers,
  zero scatters, bitwise deterministic;
- small classes (e.g. BA cameras) gather and reduce via one-hot matmuls
  (deterministic; on the H100 `take`/`segment_sum` measure ~10x faster,
  see PERF.md — choosing by backend is a ROADMAP speed item);
- everything else falls back to jnp.take / segment_sum.

Registered as a JAX pytree; under sharding the leaves are shard-local lane
slices and all tangent-space reductions psum over the mesh axis (bucket
plans degrade to segment_sum because shard-local lanes break bucket
boundaries; one-hot plans shard cleanly).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------- #
# plan-based gather / reduce primitives (shared with schur.py)
# ---------------------------------------------------------------------- #

# Lane chunking bounds XLA fusion temporaries and one-hot matmul operands
# (an [81, n] f32 operand at BAL-13682 scale (29M observations) is 9.4 GB
# unchunked; the batched-pushforward fusion temporaries take ~0.93 GB per
# million lanes). Groups up to LANE_CHUNK run single-slice (BAL-1778's 5M
# observations); larger groups use LANE_CHUNK_LARGE slices. The values
# were sized for a 16 GB device and are not re-derived for the H100.
LANE_CHUNK = 6_291_456
LANE_CHUNK_LARGE = 2_097_152


def lane_chunks(n: int, chunk: int = None):
    """[(start, size)] covering [0, n) in chunk-sized slices."""
    if chunk is None:
        chunk = LANE_CHUNK if n <= LANE_CHUNK else LANE_CHUNK_LARGE
    if n <= chunk:
        return [(0, n)]
    return [(s, min(chunk, n - s)) for s in range(0, n, chunk)]


# Two-level factorized one-hot: writing the one-hot as
# oh[c, n] = oh_hi[c//B, n] * oh_lo[c%B, n] cuts the iota-compare
# generation from cnt*n to (cnt/B + B)*n ops; the contraction keeps its
# 2*k*cnt*n FLOPs but runs against the small [A = cnt/B] axis.
ONEHOT_LO = 8


def _onehot_precision(operand_dtype):
    """Contraction precision for the one-hot matmuls standing in for
    gather/reduce.

    On the H100 an f32 contraction at DEFAULT or HIGH precision runs in
    TF32, which rounds every operand to about 5e-4 relative before the
    products are summed: for a matmul used as a gather or a reduce that
    quantizes the gathered values and every gradient / Schur-rhs
    contribution. So f32 operands use Precision.HIGHEST (exact products
    with f32 accumulation) for gathers and reduces alike. bf16 leaves
    (mixed-precision solves) keep DEFAULT: they are quantized by design,
    the one-hot side is exact in bf16, and the sums accumulate in f32
    (preferred_element_type)."""
    if operand_dtype == jnp.bfloat16:
        return None
    return jax.lax.Precision.HIGHEST


def _onehot_gather_rows(table_t, rows):
    """Gather columns of a transposed class table: [s, cnt] x rows [n] ->
    [s, n], as a two-level one-hot matmul (exact — see
    _onehot_precision)."""
    s, cnt = table_t.shape
    B = ONEHOT_LO
    A = -(-cnt // B)
    t3 = table_t
    if A * B != cnt:
        t3 = jnp.pad(table_t, ((0, 0), (0, A * B - cnt)))
    # [s, A, B] -> [s*B, A] with row s_i*B + b
    t3 = jnp.transpose(t3.reshape(s, A, B), (0, 2, 1)).reshape(s * B, A)
    rows_hi = rows // B
    rows_lo = rows % B
    oh_hi = jax.nn.one_hot(rows_hi, A, dtype=table_t.dtype, axis=0)  # [A, n]
    tmp = jnp.einsum(
        "ka,an->kn", t3, oh_hi, preferred_element_type=table_t.dtype,
        precision=_onehot_precision(table_t.dtype),
    ).reshape(s, B, rows.shape[0])
    oh_lo = jax.nn.one_hot(rows_lo, B, dtype=table_t.dtype, axis=0)  # [B, n]
    return (tmp * oh_lo[None]).sum(axis=1)


def _onehot_reduce_rows(contrib, rows, num_out, acc_dtype):
    """Segment-reduce [k, n] -> [k, num_out] as a two-level one-hot matmul
    (the transpose of _onehot_gather_rows; element-exact contributions —
    see _onehot_precision)."""
    k, n = contrib.shape
    B = ONEHOT_LO
    A = -(-num_out // B)
    rows_hi = rows // B
    rows_lo = rows % B
    oh_lo = jax.nn.one_hot(rows_lo, B, dtype=contrib.dtype, axis=0)  # [B, n]
    ctmp = (contrib[:, None, :] * oh_lo[None]).reshape(k * B, n)
    oh_hi = jax.nn.one_hot(rows_hi, A, dtype=contrib.dtype)  # [n, A]
    out = jnp.einsum(
        "Kn,na->Ka", ctmp, oh_hi, preferred_element_type=acc_dtype,
        precision=_onehot_precision(contrib.dtype),
    )  # [k*B, A]
    out = jnp.transpose(out.reshape(k, B, A), (0, 2, 1)).reshape(k, A * B)
    return out[:, :num_out]


def axis_linear_index(axis_name):
    """Linear shard index for a (possibly multi-axis) mesh axis spec.

    The hybrid DCN-aware mesh (parallel.distributed.hybrid_mesh) shards
    lanes over ("dcn", "ici"); the shard-local bucket plans only need the
    flattened position, row-major over the axis tuple (matching
    PartitionSpec(("dcn", "ici")) lane ordering)."""
    if isinstance(axis_name, (tuple, list)):
        idx = jnp.asarray(0, jnp.int32)
        for a in axis_name:
            idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
        return idx
    return jax.lax.axis_index(axis_name)


def psum_hierarchical(x, axis_name):
    """psum over a 1-D axis, or the explicit two-stage reduction over a
    hybrid mesh: reduce within the FAST inner axis (ICI) first, then
    across the host axis (DCN) — the SURVEY §2d two-level reduction (the
    inner stage runs at ICI bandwidth; only one already-reduced value per
    host crosses DCN)."""
    if isinstance(axis_name, (tuple, list)):
        for a in reversed(tuple(axis_name)):
            x = jax.lax.psum(x, a)
        return x
    return jax.lax.psum(x, axis_name)


def gather_T(plan, table, rows, axis_name=None):
    """Gather class-table rows into transposed form [s, n].

    table: [cnt(+dump), s] row-major class table.
    rows:  [n] class-row indices (used by the one-hot/fallback paths).
    plan:  ("bucket", buckets) -> slice+broadcast (no gather);
           ("bucket_sharded", buckets) -> per-shard dynamic slice+broadcast
               (column base = out_row + axis_index*per_e; reads past the
               shard's real entities land on neighbor rows or the clamped
               table edge — those lanes are masked pads, so any value is
               fine);
           ("onehot",) -> one-hot matmul (writes the [s, n] result
               directly, with no [n, s] row gather and transpose);
           otherwise -> jnp.take + transpose.
    """
    if plan is not None and plan[0] == "bucket":
        parts = []
        for (lane_start, n_seg, d, out_row) in plan[1]:
            seg = table[out_row : out_row + n_seg].T  # [s, n_seg]
            parts.append(
                jnp.broadcast_to(seg[:, None, :], (seg.shape[0], d, n_seg)).reshape(
                    seg.shape[0], d * n_seg
                )
            )
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    if plan is not None and plan[0] == "bucket_sharded":
        sidx = axis_linear_index(axis_name)
        nrows, s = table.shape
        parts = []
        for (local_start, per_e, d, out_row) in plan[1]:
            col = jnp.minimum(out_row + sidx * per_e, nrows - per_e)
            seg = jax.lax.dynamic_slice(
                table, (col, jnp.zeros_like(col)), (per_e, s)
            ).T
            parts.append(
                jnp.broadcast_to(seg[:, None, :], (s, d, per_e)).reshape(
                    s, d * per_e
                )
            )
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    if plan is not None and plan[0] == "onehot":
        return _onehot_gather_rows(table.T, rows)
    # clip: dump/pad rows may index one past the table (their lanes are
    # masked or land in the dropped dump column); NaN-fill would poison
    # whole reductions through 0 * NaN
    return jnp.take(table, rows, axis=0, mode="clip").T


def gather_T_t(plan, table_t, rows, axis_name=None):
    """gather_T for a TRANSPOSED class table [s, cnt+1(+pad)] -> [s, n].

    The t-form twin used by the table-vector ("tvec") product path: every
    access is a lane-axis slice/matmul, so no [cnt, s] <-> [s, cnt]
    transpose materializes inside the PCG while_loop (see linalg/cg.py).
    The dump (constant-block) column of table_t must be zero.
    """
    if plan is not None and plan[0] == "bucket":
        parts = []
        s = table_t.shape[0]
        for (lane_start, n_seg, d, out_row) in plan[1]:
            seg = table_t[:, out_row : out_row + n_seg]  # [s, n_seg]
            parts.append(
                jnp.broadcast_to(seg[:, None, :], (s, d, n_seg)).reshape(
                    s, d * n_seg
                )
            )
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    if plan is not None and plan[0] == "bucket_sharded":
        sidx = axis_linear_index(axis_name)
        s, ncols = table_t.shape
        parts = []
        for (local_start, per_e, d, out_row) in plan[1]:
            col = jnp.minimum(out_row + sidx * per_e, ncols - per_e)
            seg = jax.lax.dynamic_slice(
                table_t, (jnp.zeros_like(col), col), (s, per_e)
            )
            parts.append(
                jnp.broadcast_to(seg[:, None, :], (s, d, per_e)).reshape(
                    s, d * per_e
                )
            )
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    if plan is not None and plan[0] == "onehot":
        return _onehot_gather_rows(table_t, rows)
    # plan-less fallback (small problems only): row-major gather on the
    # un-transposed table (clip: see gather_T)
    return jnp.take(table_t.T, rows, axis=0, mode="clip").T


def reduce_T(plan, contrib, rows, num_out, axis_name=None, acc_dtype=None):
    """Segment-reduce transposed contributions [k, n] -> [k, num_out(+pad)].

    num_out includes the dump column (constant blocks). plan:
      ("bucket", buckets): reshape+sum per bucket (no scatter);
      ("bucket_sharded", buckets): per-shard reshape+sum written at column
          out_row + axis_index*per_e with read-modify-write accumulation
          (shard column ranges may abut); output gains SHARD_COL_PAD extra
          columns absorbing trailing-shard overhang — the caller's flatten
          drops them;
      ("onehot",): one-hot matmul (lane-chunked);
      ("segsum",) / None: transpose + segment_sum.

    acc_dtype: accumulation/output dtype (mixed precision: bf16 contribs
    accumulate in f32 — contractions take bf16 operands with an f32
    accumulator; elementwise sums cast up first).
    """
    k = contrib.shape[0]
    acc_dtype = acc_dtype or contrib.dtype
    if plan is not None and plan[0] == "bucket":
        out = jnp.zeros((k, num_out), acc_dtype)
        for (lane_start, n_seg, d, out_row) in plan[1]:
            seg = contrib[:, lane_start : lane_start + n_seg * d].astype(acc_dtype)
            if d > 1:
                seg = seg.reshape(k, d, n_seg).sum(axis=1)
            out = jax.lax.dynamic_update_slice(out, seg, (0, out_row))
        return out
    if plan is not None and plan[0] == "bucket_sharded":
        sidx = axis_linear_index(axis_name)
        out = jnp.zeros((k, num_out), acc_dtype)
        for (local_start, per_e, d, out_row) in plan[1]:
            seg = contrib[:, local_start : local_start + per_e * d].astype(acc_dtype)
            if d > 1:
                seg = seg.reshape(k, d, per_e).sum(axis=1)
            col = out_row + sidx * per_e
            zc = jnp.zeros_like(col)
            cur = jax.lax.dynamic_slice(out, (zc, col), (k, per_e))
            out = jax.lax.dynamic_update_slice(out, cur + seg, (zc, col))
        return out
    if plan is not None and plan[0] == "onehot":
        # lane-chunked: each chunk's one-hot operand slices keep the
        # (possibly virtual) contrib producer fused per chunk instead of
        # materializing a [k, n] buffer (9.4 GB at BAL-13682 scale)
        n = contrib.shape[1]
        out = jnp.zeros((k, num_out), acc_dtype)
        for (s, sz) in lane_chunks(n):
            out = out + _onehot_reduce_rows(
                contrib[:, s : s + sz], rows[s : s + sz], num_out, acc_dtype
            )
        return out
    return jax.ops.segment_sum(
        contrib.T.astype(acc_dtype), rows, num_segments=num_out
    ).T


@jax.tree_util.register_pytree_node_class
class BlockJacobian:
    """Per-(group, position) Jacobian blocks stored as [r*t, n] arrays."""

    def __init__(
        self,
        program,
        jac_groups,
        t_rows,
        axis_name=None,
        positions=None,
        shard_view=False,
        col_scale=None,
    ):
        self.program = program
        self.jac_groups = jac_groups  # tuple over groups of tuple over pos: [r*t, n]
        self.t_rows = t_rows  # tuple over groups of tuple over pos [n]
        self.axis_name = axis_name
        if positions is None:
            positions = tuple(tuple(range(len(jacs))) for jacs in jac_groups)
        self.positions = positions
        # True when the leaves are the GLOBAL view of shard-ordered arrays
        # (outside shard_map): neither the global bucket plan (wrong lane
        # order) nor the shard plan (needs axis_index) applies.
        self.shard_view = shard_view
        # Lazy Jacobi column scaling: J_s = J diag(col_scale) without
        # rewriting the [r*t, n] leaves (a 480 MB materialization per LM
        # iteration at BAL-1778 scale). Products apply the diagonal at the
        # tangent-vector boundary; per-block Gram tables post-scale by the
        # per-block outer product (every lane of a block shares its scale).
        self.col_scale = col_scale  # [num_effective_parameters] or None

    # -- pytree protocol ------------------------------------------------ #

    def tree_flatten(self):
        children = (self.jac_groups, self.t_rows, self.col_scale)
        aux = (self.program, self.axis_name, self.positions, self.shard_view)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        program, axis_name, positions = aux[0], aux[1], aux[2]
        shard_view = aux[3] if len(aux) > 3 else False
        jac_groups, t_rows = children[0], children[1]
        col_scale = children[2] if len(children) > 2 else None
        return cls(
            program, jac_groups, t_rows, axis_name, positions, shard_view,
            col_scale,
        )

    @classmethod
    def build(cls, program, arrays, jac_groups, axis_name=None):
        t_rows = tuple(g["t_rows"] for g in arrays["groups"])
        return cls(program, tuple(jac_groups), t_rows, axis_name)

    def position_view(self, keep_positions):
        """Restrict to a subset of parameter positions per group — the E or F
        half of the Schur partition (reference: partitioned_matrix_view_impl.h)."""
        jac_groups, t_rows, positions = [], [], []
        for gi, keep in enumerate(keep_positions):
            keep = tuple(keep)
            orig = self.positions[gi]
            sel = tuple(orig.index(p) for p in keep)
            jac_groups.append(tuple(self.jac_groups[gi][s] for s in sel))
            t_rows.append(tuple(self.t_rows[gi][s] for s in sel))
            positions.append(keep)
        return BlockJacobian(
            self.program,
            tuple(jac_groups),
            tuple(t_rows),
            self.axis_name,
            tuple(positions),
            self.shard_view,
            self.col_scale,
        )

    # -- shapes / plumbing ------------------------------------------------ #

    @property
    def num_cols(self) -> int:
        return self.program.num_effective_parameters

    @property
    def num_rows(self) -> int:
        return self.program.num_residuals

    def _psum(self, x):
        if not self.axis_name:
            return x
        return psum_hierarchical(x, self.axis_name)

    def _dtype(self):
        for jacs in self.jac_groups:
            for j in jacs:
                return j.dtype
        return jnp.float32

    def _acc_dtype(self):
        """Accumulation dtype: bf16 leaves accumulate in f32."""
        dt = self._dtype()
        return jnp.float32 if dt == jnp.bfloat16 else dt

    def astype(self, dtype):
        """Cast the [r*t, n] leaves (mixed-precision solves: bf16 leaves
        halve the memory traffic of every product; reductions still
        accumulate in f32). reference analog:
        CUDADenseCholeskyMixedPrecision (dense_cholesky.h:246) — fp32
        factorization + fp64 refinement; here fp32 is the outer precision
        and bf16 the inner-product precision, validated by the trust
        region's own step accept/reject loop."""
        if dtype == self._dtype():
            return self
        jac_groups = tuple(
            tuple(j.astype(dtype) for j in jacs) for jacs in self.jac_groups
        )
        return BlockJacobian(
            self.program,
            jac_groups,
            self.t_rows,
            self.axis_name,
            self.positions,
            self.shard_view,
            self.col_scale,
        )

    def _group_n(self, gi) -> int:
        """Lane count of group gi (shard-local under sharding)."""
        if self.t_rows[gi]:
            return self.t_rows[gi][0].shape[0]
        return self.program.groups[gi].n

    def _iter(self, gi):
        """Yields (vpos, pos_meta, jac [r*t, n], t_rows [n]) for group gi."""
        meta = self.program.groups[gi]
        for vpos, (jac, tr) in enumerate(zip(self.jac_groups[gi], self.t_rows[gi])):
            pm = meta.positions[self.positions[gi][vpos]]
            yield vpos, pm, jac, tr

    def plan(self, gi, vpos):
        """Reduction/gather plan for (group, view-position).

        Under shard_map (axis_name set) the owner position uses the
        shard-local bucket plan published by build_sharded_arrays
        (program.build_shard_layout); one-hot plans shard as-is. Global
        bucket plans describe the unpadded single-device lane layout and
        degrade to segment_sum on any other view (shard-local slices
        without a shard layout, or padded global views)."""
        meta = self.program.groups[gi]
        pos = self.positions[gi][vpos]
        if self.axis_name is not None:
            splans = meta.shard_red_plans or {}
            if pos in splans:
                return splans[pos]
        plans = meta.red_plans or {}
        plan = plans.get(pos)
        if (
            plan is not None
            and plan[0] == "bucket"
            and (
                self.axis_name is not None
                or self.shard_view
                or self._group_n(gi) != meta.n
            )
        ):
            return ("segsum",)
        return plan

    def _col_pad(self) -> int:
        """Extra accumulator columns absorbing sharded-bucket overhang
        (trailing shards write up to ndev-1 columns past the dump)."""
        if self.axis_name is None:
            return 0
        return max(
            (meta.shard_ndev or 0) for meta in self.program.groups
        ) if self.program.groups else 0

    def _v_tables(self, v):
        from .evaluator import tangent_tables

        return tangent_tables(self.program, v, pad_zero_row=True)

    def _class_tables_T(self):
        """Zero per-class accumulators in transposed form
        [s, cnt+1+col_pad] (dump column + sharded-bucket overhang pad)."""
        p = self.program
        dtype = self._acc_dtype()
        pad = 1 + self._col_pad()
        return [
            jnp.zeros((s, cnt + pad), dtype)
            for cnt, s in zip(p.tangent_class_counts, p.tangent_class_sizes)
        ]

    def _flatten_classes_T(self, tables):
        """[s, cnt+1+pad] per class -> flat tangent vector (drop dump/pad
        columns)."""
        p = self.program
        parts = [
            t[:, :cnt].T.reshape(-1)
            for t, cnt in zip(tables, p.tangent_class_counts)
        ]
        if not parts:
            return jnp.zeros(0, self._acc_dtype())
        return jnp.concatenate(parts)

    # -- table-vector ("tvec") form ---------------------------------------- #
    #
    # A tangent vector represented as per-class TRANSPOSED tables
    # [s, cnt+1+pad] (dump + shard-pad columns zero). All products,
    # preconditioner applies, and CG vector algebra run directly in this
    # form, so the [cnt, s] <-> [s, cnt] class-table transposes — which
    # XLA materializes as physical relayouts on every lax.while_loop
    # iteration — happen exactly twice per linear solve (entry/exit)
    # instead of several times per PCG iteration. The SURVEY §7 "PCG over
    # a vector protocol" design.

    def tvec(self, v):
        """flat [num_eff] -> list of per-class [s, cnt+1+pad] tables."""
        p = self.program
        pad = 1 + self._col_pad()
        out = []
        for cls in range(len(p.tangent_class_sizes)):
            base, cnt, s = p.tangent_class_slice(cls)
            t = v[base : base + cnt * s].reshape(cnt, s).T  # [s, cnt]
            out.append(
                jnp.concatenate([t, jnp.zeros((s, pad), v.dtype)], axis=1)
            )
        return out

    def tvec_flat(self, tv):
        """Inverse of tvec (drops dump/pad columns)."""
        return self._flatten_classes_T(tv)

    def tvec_zeros(self, dtype=None):
        p = self.program
        dtype = dtype or self._acc_dtype()
        pad = 1 + self._col_pad()
        return [
            jnp.zeros((s, cnt + pad), dtype)
            for cnt, s in zip(p.tangent_class_counts, p.tangent_class_sizes)
        ]

    def _zero_pad_cols(self, tv):
        """Zero the dump/pad columns (constant-block sums must not feed
        back into gathers)."""
        p = self.program
        out = []
        for cls, t in enumerate(tv):
            cnt = p.tangent_class_counts[cls]
            s = t.shape[0]
            out.append(
                jnp.concatenate(
                    [t[:, :cnt], jnp.zeros((s, t.shape[1] - cnt), t.dtype)],
                    axis=1,
                )
            )
        return out

    def right_multiply_t(self, tv):
        """J v for a tvec v -> per-group residuals [r, n]. col_scale must
        already be folded into the leaves (materialize_scale)."""
        assert self.col_scale is None, (
            "tvec products require materialize_scale() first"
        )
        leaf_dt = self._dtype()
        acc_dt = self._acc_dtype()
        out = []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            acc = jnp.zeros((r, n), acc_dt)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, vpos)
                vg = gather_T_t(
                    plan,
                    tv[pm.t_cls].astype(leaf_dt),
                    tr,
                    self.axis_name,
                )  # [t, n]
                acc = acc + (jac.reshape(r, t, n) * vg[None]).sum(axis=1).astype(
                    acc_dt
                )
            out.append(acc)
        return out

    def left_multiply_t(self, u_groups):
        """J^T u -> tvec (dump/pad columns zeroed; psummed under
        sharding). col_scale must already be folded into the leaves."""
        assert self.col_scale is None, (
            "tvec products require materialize_scale() first"
        )
        acc = self._class_tables_T()
        leaf_dt = self._dtype()
        acc_dt = self._acc_dtype()
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            u = u_groups[gi].astype(leaf_dt)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, vpos)
                contrib = (jac.reshape(r, t, n) * u[:, None, :]).sum(axis=0)
                acc[pm.t_cls] = acc[pm.t_cls] + reduce_T(
                    plan,
                    contrib,
                    tr,
                    acc[pm.t_cls].shape[1],
                    self.axis_name,
                    acc_dtype=acc_dt,
                )
        return self._zero_pad_cols([self._psum(a) for a in acc])

    # -- products --------------------------------------------------------- #

    def right_multiply(self, v):
        """J v: tangent vector [num_cols] -> per-group residuals [r, n].

        reference: BlockSparseMatrix::RightMultiplyAndAccumulate.
        """
        if self.col_scale is not None:
            v = v * self.col_scale
        vt = self._v_tables(v)
        leaf_dt = self._dtype()
        acc_dt = self._acc_dtype()
        out = []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            acc = jnp.zeros((r, n), acc_dt)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, vpos)
                vg = gather_T(
                    plan,
                    vt[pm.t_cls].astype(leaf_dt),
                    tr,
                    self.axis_name,
                )  # [t, n], leaf precision
                acc = acc + (jac.reshape(r, t, n) * vg[None]).sum(axis=1).astype(
                    acc_dt
                )
            out.append(acc)
        return out

    def left_multiply(self, u_groups):
        """J^T u for per-group residuals u [r, n] -> [num_cols].

        reference: BlockSparseMatrix::LeftMultiplyAndAccumulate; the
        reference's atomicAdd becomes a deterministic reshape-sum / one-hot
        matmul / segment-sum depending on the position's plan.
        """
        acc = self._class_tables_T()
        leaf_dt = self._dtype()
        acc_dt = self._acc_dtype()
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            u = u_groups[gi].astype(leaf_dt)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                cnt = self.program.tangent_class_counts[pm.t_cls]
                plan = self.plan(gi, vpos)
                contrib = (jac.reshape(r, t, n) * u[:, None, :]).sum(axis=0)
                acc[pm.t_cls] = acc[pm.t_cls] + reduce_T(
                    plan,
                    contrib,
                    tr,
                    acc[pm.t_cls].shape[1],
                    self.axis_name,
                    acc_dtype=acc_dt,
                )
        out = self._psum(self._flatten_classes_T(acc))
        if self.col_scale is not None:
            out = out * self.col_scale
        return out

    def jtj_multiply(self, v, dsq=None):
        """(J^T J + diag(dsq)) v — the CGNR/LM normal-equations operator.

        reference: CgnrSolver operator (cgnr_solver.cc:219-242).
        """
        jv = self.right_multiply(v)
        out = self.left_multiply(jv)
        if dsq is not None:
            out = out + dsq * v
        return out

    def squared_column_norms(self):
        """Per-tangent-column sum of squares (LM diagonal / Jacobi scaling)."""
        acc = self._class_tables_T()
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                cnt = self.program.tangent_class_counts[pm.t_cls]
                j3 = jac.reshape(r, t, n)
                acc[pm.t_cls] = acc[pm.t_cls] + reduce_T(
                    self.plan(gi, vpos),
                    (j3 * j3).sum(axis=0),
                    tr,
                    acc[pm.t_cls].shape[1],
                    self.axis_name,
                    acc_dtype=self._acc_dtype(),
                )
        out = self._psum(self._flatten_classes_T(acc))
        if self.col_scale is not None:
            out = out * self.col_scale * self.col_scale
        return out

    def scale_columns(self, scale):
        """Return a LAZY column-scaled view J diag(scale) (Jacobi scaling;
        reference: trust_region_minimizer.cc). The [r*t, n] leaves are
        shared, not copied; see `col_scale`. Composes multiplicatively."""
        col_scale = scale if self.col_scale is None else self.col_scale * scale
        return BlockJacobian(
            self.program,
            self.jac_groups,
            self.t_rows,
            self.axis_name,
            self.positions,
            self.shard_view,
            col_scale,
        )

    def materialize_scale(self):
        """Fold `col_scale` into the leaves (for consumers that read the
        raw [r*t, n] arrays, e.g. visibility/explicit-Schur assembly)."""
        if self.col_scale is None:
            return self
        st = self._v_tables(self.col_scale)
        new_groups = []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            jacs = []
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    jacs.append(jac)
                    continue
                t = pm.tangent_size
                sg = gather_T(
                    self.plan(gi, vpos), st[pm.t_cls], tr, self.axis_name
                )  # [t, n]
                jacs.append(
                    (jac.reshape(r, t, n) * sg[None]).reshape(r * t, n)
                )
            new_groups.append(tuple(jacs))
        return BlockJacobian(
            self.program,
            tuple(new_groups),
            self.t_rows,
            self.axis_name,
            self.positions,
            self.shard_view,
        )

    # -- block-diagonal J^T J  ------------------------------------------- #

    def block_diag_jtj(self, dsq=None, class_ids=None):
        """Per-parameter-block diagonal blocks of J^T J (+ diag(dsq)).

        Returns a list over tangent classes of TRANSPOSED [s*s, count]
        tables (block (i,j) of class row c at [i*s+j, c]) — the input of the
        JACOBI preconditioner and of (E^T E)^{-1} in implicit Schur.
        reference: block_jacobi_preconditioner.cc.
        """
        p = self.program
        dtype = self._acc_dtype()
        col_pad = 1 + self._col_pad()
        per_class = [
            jnp.zeros((s * s, cnt + col_pad), dtype)
            for cnt, s in zip(p.tangent_class_counts, p.tangent_class_sizes)
        ]
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n = self._group_n(gi)
            r = meta.num_residuals
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                if class_ids is not None and pm.t_cls not in class_ids:
                    continue
                cnt = p.tangent_class_counts[pm.t_cls]
                t = pm.tangent_size
                j3 = jac.reshape(r, t, n)
                outer = (j3[:, :, None, :] * j3[:, None, :, :]).sum(axis=0)
                per_class[pm.t_cls] = per_class[pm.t_cls] + reduce_T(
                    self.plan(gi, vpos),
                    outer.reshape(t * t, n),
                    tr,
                    per_class[pm.t_cls].shape[1],
                    self.axis_name,
                    acc_dtype=self._acc_dtype(),
                )
        out = []
        from .evaluator import tangent_tables

        if dsq is not None:
            dt = tangent_tables(p, dsq)
        if self.col_scale is not None:
            sc = tangent_tables(p, self.col_scale)
        for cls, acc in enumerate(per_class):
            s = p.tangent_class_sizes[cls]
            cnt = p.tangent_class_counts[cls]
            acc = self._psum(acc[:, :cnt])  # [s*s, cnt]
            if self.col_scale is not None:
                # every lane of a block shares its scale: post-scale the
                # reduced Gram table by the per-block outer product
                scl = sc[cls].T  # [s, cnt]
                acc = acc * (scl[:, None, :] * scl[None, :, :]).reshape(
                    s * s, cnt
                )
            if dsq is not None:
                diag_rows = np.arange(s) * s + np.arange(s)
                acc = acc.at[diag_rows, :].add(dt[cls].T)
            out.append(acc)
        return out

    # -- materialization (small problems / parity export) ----------------- #

    def to_dense(self):
        """Dense [num_rows, num_cols] Jacobian (small problems / tests)."""
        dtype = self._dtype()
        num_cols_pad = self.num_cols + max(
            (self.program.tangent_class_sizes or [1])
        )
        a = jnp.zeros((self.num_rows, num_cols_pad), dtype=dtype)
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n_arr = self._group_n(gi)
            n, r = meta.n, meta.num_residuals  # logical rows (unpadded)
            rows = meta.row_offset + jnp.arange(n * r).reshape(n, r, 1)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                cnt = self.program.tangent_class_counts[pm.t_cls]
                base = int(self.program.tangent_class_bases[pm.t_cls])
                t = pm.tangent_size
                jl = jnp.transpose(jac.reshape(r, t, n_arr), (2, 0, 1))[:n]
                trl = tr[:n]
                col0 = jnp.where(trl < cnt, base + trl * t, self.num_cols)
                cols = col0[:, None, None] + jnp.arange(t)[None, None, :]
                cols = jnp.broadcast_to(cols, jl.shape)
                rr = jnp.broadcast_to(rows, jl.shape)
                a = a.at[rr, cols].add(jl)
        a = a[:, : self.num_cols]
        if self.col_scale is not None:
            a = a * self.col_scale[None, :]
        return a

    def to_crs(self):
        """Host-side CRS triple (values, col_indices, row_pointers) over free
        tangent columns. reference: CompressedRowSparseMatrix layout."""
        rows_list, cols_list, vals_list = [], [], []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n_arr = self._group_n(gi)
            n, r = meta.n, meta.num_residuals
            base_rows = meta.row_offset + np.arange(n * r).reshape(n, r, 1)
            for vpos, pm, jac, tr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                jl = (
                    np.asarray(jac)
                    .reshape(r, t, n_arr)
                    .transpose(2, 0, 1)[:n]
                )
                trl = np.asarray(tr)[:n]
                cnt = self.program.tangent_class_counts[pm.t_cls]
                base = int(self.program.tangent_class_bases[pm.t_cls])
                cols = base + trl[:, None, None] * t + np.arange(t)[None, None, :]
                cols = np.broadcast_to(cols, (n, r, t)).reshape(-1)
                rows = np.broadcast_to(base_rows, (n, r, t)).reshape(-1)
                vals = jl.reshape(-1)
                keep = np.broadcast_to(
                    (trl < cnt)[:, None, None], (n, r, t)
                ).reshape(-1)
                rows_list.append(rows[keep])
                cols_list.append(cols[keep])
                vals_list.append(vals[keep])
        if not rows_list:
            return (
                np.zeros(0),
                np.zeros(0, dtype=np.int32),
                np.zeros(self.num_rows + 1, dtype=np.int32),
            )
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        vals = np.concatenate(vals_list)
        if self.col_scale is not None:
            vals = vals * np.asarray(self.col_scale)[cols]
        from .io.native import coo_to_crs

        perm, row_ptr = coo_to_crs(rows, cols, self.num_rows)
        return vals[perm], cols[perm].astype(np.int32), row_ptr.astype(np.int32)
