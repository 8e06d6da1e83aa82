"""Multi-chip data parallelism: residual blocks sharded over a device mesh.

The reference is single-process/single-GPU; its only parallel axis is
thread/CUDA-thread data parallelism over residual blocks (SURVEY.md §2d).
The framework's scaling design (BASELINE.json north star): partition
every signature group's residual blocks across the mesh axis, replicate the
state vector and all tangent-space vectors, and express every reduction the
reference performs with thrust::reduce / atomicAdd / per-thread scratch as
an on-chip segment-sum followed by a cross-device psum:

  cost      -> local sum          -> psum
  gradient  -> local scatter-add  -> psum
  J^T u     -> local scatter-add  -> psum   (inside every CG iteration)
  block JtJ -> local scatter-add  -> psum   (preconditioner build)

The PCG loops (CGNR / implicit Schur) run *inside* shard_map: replicated
vector iterates, sharded matrix products — collectives ride the ICI.

Groups are padded to a multiple of the mesh size with masked rows (the mask
zeroes residuals and Jacobians before any reduction).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..evaluator import Evaluator, evaluate
from ..utils.dtypes import default_dtype, full_f32_matmuls


def _pad_rows(a: np.ndarray, target: int, pad_value=0):
    n = a.shape[0]
    if n == target:
        return a
    pad = np.full((target - n,) + a.shape[1:], pad_value, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _materialize_rows(a, rows):
    """Gather `rows` of a data leaf; supports ndarray and io.lazy.LazyRows
    (the file-backed handle that lets a multi-host run avoid ever holding
    the full observation payload on one process)."""
    from ..io.lazy import LazyRows

    if isinstance(a, LazyRows):
        return a.gather(rows)
    return np.asarray(a)[rows]


def _leaf_shape_dtype(a):
    from ..io.lazy import LazyRows

    if isinstance(a, LazyRows):
        return a.shape, a.dtype
    a = np.asarray(a)
    return a.shape, a.dtype


def put_global(mesh: Mesh, spec, leaf_fn, global_shape, dtype):
    """Assemble a global jax.Array for `spec` over `mesh` from per-device
    numpy shards produced by `leaf_fn(index_tuple)`.

    Single-process: one device_put of the full array (leaf_fn(None)).
    Multi-process (jax.process_count() > 1): each process materializes ONLY
    the row blocks its addressable devices own and the global array is
    stitched with jax.make_array_from_single_device_arrays — no process
    ever holds or transfers the whole leaf. This is the answer
    to the reference's single-GPU bulk upload (registered_cuda_evaluators
    .cc:239-272) at multi-host scale (SURVEY.md §2d:332-339).
    """
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(np.asarray(leaf_fn(None), dtype=dtype), sh)
    imap = sh.addressable_devices_indices_map(tuple(global_shape))
    cache: dict = {}
    shards = []
    for d, idx in imap.items():
        key = tuple(
            (s.start, s.stop, s.step) if isinstance(s, slice) else s
            for s in (idx or ())
        )
        if key not in cache:
            cache[key] = np.asarray(leaf_fn(idx), dtype=dtype)
        shards.append(jax.device_put(cache[key], d))
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sh, shards
    )


def mesh_axis_size(mesh: Mesh, axis) -> int:
    """Total shard count along a (possibly tuple) mesh axis spec."""
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def build_sharded_arrays(program, mesh: Mesh, axis, dtype=None):
    """Lay out each group's tensors in the shard-aware lane order (see
    Program.build_shard_layout): shard-major lanes, each shard's slice in
    its own interleaved bucket order so the scatter-free reduction plans
    survive sharding; masked pad lanes fill the per-shard remainders.

    Multi-process aware: every leaf is constructed through put_global, so
    under jax.distributed each process builds only the shards its local
    devices own (per-process shard construction — the multi-host half of
    BASELINE config 5)."""
    dtype = dtype or default_dtype()
    ndev = mesh_axis_size(mesh, axis)
    num_eff = program.num_effective_parameters
    layouts = program.build_shard_layout(ndev)
    # record the active layout so global-view consumers (e.g. the
    # visibility preconditioners' original-order reorder) can recover the
    # lane permutation
    program._active_shard_ndev = ndev

    def put(spec, leaf_fn, shape, leaf_dtype):
        return put_global(mesh, spec, leaf_fn, shape, leaf_dtype)

    def put_rep(a, leaf_dtype=None):
        a = np.asarray(a)
        return put(P(), lambda idx: a, a.shape, leaf_dtype or a.dtype)

    groups = []
    for gi, (meta, idx) in enumerate(zip(program.groups, program.group_idx)):
        lay = layouts[gi]
        perm = lay["perm"]
        L = perm.size

        def take_perm(a, fill, region, tail_shape, a_dtype):
            """Rows `region` (an index tuple from the sharding, or None =
            all) of the permuted+padded leaf, materializing only the
            source rows that land in the region."""
            p = perm if region is None else perm[region[0]]
            valid = p >= 0
            out = np.full((p.size,) + tail_shape, fill, dtype=a_dtype)
            out[valid] = _materialize_rows(a, p[valid])
            return out

        def put_row_leaf(a, fill, cast=None):
            shape, a_dtype = _leaf_shape_dtype(a)
            tail = shape[1:]
            if cast is not None and np.issubdtype(a_dtype, np.floating):
                out_dtype = cast
            else:
                out_dtype = a_dtype
            row_spec = P(*((axis,) + (None,) * len(tail)))
            return put(
                row_spec,
                lambda region: take_perm(a, fill, region, tail, a_dtype),
                (L,) + tail,
                out_dtype,
            )

        t_rows_padded = []
        for pos, pm in enumerate(meta.positions):
            dump = (
                program.tangent_class_counts[pm.t_cls] if pm.t_cls >= 0 else 0
            )
            t_rows_padded.append(put_row_leaf(idx["t_rows"][pos], dump))
        g = {
            "a_rows": tuple(put_row_leaf(a, 0) for a in idx["a_rows"]),
            "t_rows": tuple(t_rows_padded),
            "data": tuple(
                put_row_leaf(d, 0, cast=dtype) for d in idx["data"]
            ),
            "mask": put(
                P(axis),
                lambda region: (
                    (perm if region is None else perm[region[0]]) >= 0
                ).astype(dtype),
                (L,),
                dtype,
            ),
        }
        groups.append(g)
        # publish the shard-local plans for BlockJacobian.plan()
        if lay["shard_buckets"] is not None:
            meta.shard_red_plans = {
                meta.owner: ("bucket_sharded", lay["shard_buckets"])
            }
        else:
            meta.shard_red_plans = {}
        meta.shard_ndev = ndev

    arrays = {
        "groups": groups,
        "plus_euclid": [
            None
            if rec is None
            else {"t_row_map": put_rep(rec["t_row_map"])}
            for rec in program.plus_euclid
        ],
        "manifold_groups": [
            {"a_rows": put_rep(g["a_rows"]), "t_rows": put_rep(g["t_rows"])}
            for g in program.manifold_group_idx
        ],
    }
    if program.has_bounds:
        arrays["lower_bound"] = put_rep(program.lower_bound, dtype)
        arrays["upper_bound"] = put_rep(program.upper_bound, dtype)

    specs = arrays_pspecs(program, arrays, axis)
    return arrays, specs


def arrays_pspecs(program, arrays, axis: str):
    """PartitionSpec pytree matching build_sharded_arrays output: group
    tensors sharded on their leading (residual-block) axis, everything else
    replicated."""

    def group_spec(g):
        return {
            "a_rows": tuple(P(axis) for _ in g["a_rows"]),
            "t_rows": tuple(P(axis) for _ in g["t_rows"]),
            "data": tuple(P(*((axis,) + (None,) * (d.ndim - 1))) for d in g["data"]),
            "mask": P(axis),
        }

    specs = {
        "groups": [group_spec(g) for g in arrays["groups"]],
        "plus_euclid": [
            None if rec is None else {"t_row_map": P(None)}
            for rec in arrays["plus_euclid"]
        ],
        "manifold_groups": [
            {"a_rows": P(None), "t_rows": P(None)}
            for _ in arrays["manifold_groups"]
        ],
    }
    if "lower_bound" in arrays:
        specs["lower_bound"] = P(None)
        specs["upper_bound"] = P(None)
    return specs


def jac_pspecs(program, axis: str):
    """PartitionSpec pytree for a BlockJacobian produced under sharding
    (leaves are transposed [r*t, n] arrays, sharded on the lane axis)."""
    jac_groups = tuple(
        tuple(P(None, axis) for _ in meta.positions) for meta in program.groups
    )
    t_rows = tuple(
        tuple(P(axis) for _ in meta.positions) for meta in program.groups
    )
    # third child: col_scale (None for the unscaled Jacobian the evaluator
    # produces — a None pytree child has no leaves, so no spec either)
    return (jac_groups, t_rows, None)


def res_groups_pspecs(program, axis: str):
    # per-group [r, n] residuals, sharded on the lane (observation) axis
    return [P(None, axis) for _ in program.groups]


class ShardedEvaluator(Evaluator):
    """Evaluator whose group tensors are sharded over `mesh[axis]`.

    Drop-in for Evaluator in the trust-region minimizer: evaluate_groups /
    cost / plus keep identical signatures; residual groups and the
    BlockJacobian stay device-sharded between calls.
    """

    def __init__(self, program, mesh: Mesh, axis="dp", dtype=None):
        self.program = program
        self.mesh = mesh
        if len(mesh.axis_names) > 1:
            # hybrid DCN-aware mesh (parallel.distributed.hybrid_mesh):
            # lanes shard over every axis, reductions run two-stage
            # (psum_hierarchical) — the passed `axis` is ignored
            axis = tuple(mesh.axis_names)
        self.axis = axis
        self.axis_name = axis
        self.dtype = dtype or default_dtype()
        self.arrays, self.arrays_specs = build_sharded_arrays(
            program, mesh, axis, self.dtype
        )

        rep = P()
        jac_specs = jac_pspecs(program, axis)
        res_specs = res_groups_pspecs(program, axis)

        def _eval_impl(arrays, state, with_jacobian):
            cost, res_groups, jac, grad = evaluate(
                program, arrays, state, with_jacobian=with_jacobian, axis_name=axis
            )
            if not with_jacobian:
                return cost, res_groups, None, grad
            # return raw children: shard_map out_specs match plain pytrees
            return cost, res_groups, (jac.jac_groups, jac.t_rows, jac.col_scale), grad

        self._evaluate_sharded = jax.jit(
            jax.shard_map(
                lambda arrays, state: _eval_impl(arrays, state, True),
                mesh=mesh,
                check_vma=True,
                in_specs=(self.arrays_specs, rep),
                out_specs=(rep, res_specs, jac_specs, rep),
            )
        )
        self._cost_sharded = jax.jit(
            jax.shard_map(
                lambda arrays, state: _eval_impl(arrays, state, False)[0],
                mesh=mesh,
                check_vma=True,
                in_specs=(self.arrays_specs, rep),
                out_specs=rep,
            )
        )
        from ..evaluator import plus as plus_fn

        self._plus_sharded = jax.jit(
            jax.shard_map(
                lambda arrays, state, delta: plus_fn(program, arrays, state, delta),
                mesh=mesh,
                check_vma=True,
                in_specs=(self.arrays_specs, rep, rep),
                out_specs=rep,
            )
        )

    # -- Evaluator-compatible API -------------------------------------- #

    @full_f32_matmuls
    def cost(self, state):
        return self._cost_sharded(self.arrays, state)

    @full_f32_matmuls
    def evaluate_groups(self, state, apply_loss: bool = True):
        cost, res_groups, (jac_g, t_rows, _), grad = self._evaluate_sharded(
            self.arrays, state
        )
        from ..jacobian import BlockJacobian

        # axis_name=None: outside shard_map the children are global sharded
        # arrays and reductions are ordinary (GSPMD-parallelized) ops;
        # wrap_step_fn rebuilds the axis-local view inside its shard_map.
        # shard_view: the global lane order is shard-major-interleaved, so
        # the single-device bucket plan must not be applied.
        jac = BlockJacobian(
            self.program, jac_g, t_rows, axis_name=None, shard_view=True
        )
        return cost, res_groups, jac, grad

    @full_f32_matmuls
    def plus(self, state, delta):
        return self._plus_sharded(self.arrays, state, delta)

    def wrap_prepare(self, prepare_fn):
        """shard_map a strategy prepare function (the J-dependent half of
        the prepare/finish split) so its Gram reductions run with the
        shard-local plans and psum — the same environment the chunk body
        rebuilds the cache in."""
        rep = P()
        jac_specs = jac_pspecs(self.program, self.axis)
        res_specs = tuple(res_groups_pspecs(self.program, self.axis))

        from ..jacobian import BlockJacobian

        def _prepare_inner(jac_children, res_groups, grad, scale):
            jac_g, t_rows, col_scale = jac_children
            jac = BlockJacobian(
                self.program, jac_g, t_rows, axis_name=self.axis,
                col_scale=col_scale,
            )
            return prepare_fn(jac, list(res_groups), grad, scale)

        _sharded_prepare = jax.jit(
            jax.shard_map(
                _prepare_inner,
                mesh=self.mesh,
                check_vma=True,
                in_specs=(jac_specs, res_specs, rep, rep),
                out_specs=rep,
            )
        )

        def wrapper(jac, res_groups, grad, scale):
            children, _ = jac.tree_flatten()
            return _sharded_prepare(children, tuple(res_groups), grad, scale)

        return wrapper

    def wrap_step_fn(self, step_fn_raw):
        """shard_map a strategy step function (strategies.make_lm_step_fn's
        inner fn) so its matrix products run sharded with psum reductions."""
        rep = P()
        jac_specs = jac_pspecs(self.program, self.axis)
        res_specs = res_groups_pspecs(self.program, self.axis)

        def wrapper(jac, res_groups, grad, radius, scale):
            children, _ = jac.tree_flatten()
            return _sharded_step(children, res_groups, grad, radius, scale)

        from ..jacobian import BlockJacobian

        def _step_inner(jac_children, res_groups, grad, radius, scale):
            jac_g, t_rows, col_scale = jac_children
            jac = BlockJacobian(
                self.program, jac_g, t_rows, axis_name=self.axis,
                col_scale=col_scale,
            )
            return step_fn_raw(jac, res_groups, grad, radius, scale)

        _sharded_step = jax.jit(
            jax.shard_map(
                _step_inner,
                mesh=self.mesh,
                check_vma=True,
                in_specs=(jac_specs, res_specs, rep, rep, rep),
                out_specs=(rep, rep, rep, rep),
            )
        )
        return wrapper
