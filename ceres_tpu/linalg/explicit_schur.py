"""Explicit sparse Schur complement (SPARSE_SCHUR).

reference: SparseSchurComplementSolver (schur_complement_solver.cc:265-408):
the SchurEliminator assembles S into a BlockRandomAccessSparseMatrix with
one cell per camera pair that shares a point, then a host sparse Cholesky
factors it.

Design: the block sparsity (unique camera pairs per shared point) is
planned once on the host from the Program's index tables; per iteration the
blocks are assembled on device — per-point batched triangular solves
(E'E + D)^(-1/2) and pair-block einsums, one deterministic segment-sum per
chunk into the compact slot table — then a single D2H transfer hands the
block-sparse S to SuperLU (the same host-library role the reference gives
SuiteSparse). Back-substitution for the eliminated blocks runs on device.

Like the reference's eliminator this assumes the BA shape (one e-block and
one camera class per residual); other shapes use DENSE_SCHUR's implicit
materialization instead.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .visibility import (
    PAIR_CHUNK,
    POINT_CHUNK_FLOATS,
    _camera_streams,
    _gather_rows,
)


class ExplicitSchurPlan:
    """Host-side block-sparsity plan + device assembly for explicit S."""

    def __init__(self, program, jac_e, jac_f):
        e_cls, cam_cls, streams = _camera_streams(program, jac_e, jac_f)
        self.e_cls, self.cam_cls = e_cls, cam_cls
        self.n_cams = program.tangent_class_counts[cam_cls]
        self.tf = program.tangent_class_sizes[cam_cls]
        self.te = program.tangent_class_sizes[e_cls]
        self._plan(program, streams)

    @classmethod
    def get(cls, program, jac_e, jac_f):
        plan = getattr(program, "_explicit_schur_plan", None)
        if plan is None:
            plan = cls(program, jac_e, jac_f)
            program._explicit_schur_plan = plan
        return plan

    def _plan(self, program, streams):
        n_cams = self.n_cams
        chunks = []  # (gi, fv, d, r, obs [m,d], pts [m], cam pairs per chunk)
        all_keys = [np.arange(n_cams, dtype=np.int64) * n_cams + np.arange(n_cams)]
        for gi, _ev, fv, pt_rows, cam_rows in streams:
            order = np.argsort(pt_rows, kind="stable")
            spt = pt_rows[order]
            uniq, starts, counts = np.unique(
                spt, return_index=True, return_counts=True
            )
            r = program.groups[gi].num_residuals
            for d in np.unique(counts):
                d = int(d)
                sel = counts == d
                obs_idx = order[starts[sel][:, None] + np.arange(d)[None, :]]
                pt_of = uniq[sel]
                m_total = obs_idx.shape[0]
                mc = max(
                    1,
                    POINT_CHUNK_FLOATS
                    // max(1, d * r * (self.te + self.tf) + d * d * 4),
                )
                for s0 in range(0, m_total, mc):
                    oi = obs_idx[s0 : s0 + mc]
                    pts = pt_of[s0 : s0 + mc]
                    cams = cam_rows[oi]  # [m, d]
                    valid = cams < n_cams
                    va = valid[:, :, None] & valid[:, None, :]
                    p, a, b = np.nonzero(va)
                    keys = (
                        cams[p, a].astype(np.int64) * n_cams + cams[p, b]
                    )
                    all_keys.append(np.unique(keys))
                    chunks.append(
                        dict(
                            gi=gi, fv=fv, d=d, r=r,
                            obs=oi.astype(np.int32),
                            pts=pts.astype(np.int32),
                            src_a=(p * d + a).astype(np.int32),
                            src_b=(p * d + b).astype(np.int32),
                            keys=keys,
                        )
                    )
        slots = np.unique(np.concatenate(all_keys))
        self.n_slots = len(slots)
        # chunk keys -> slot indices
        for ch in chunks:
            ch["slot"] = np.searchsorted(slots, ch.pop("keys")).astype(np.int32)
        self.chunks = chunks
        self.diag_slots = np.searchsorted(
            slots, np.arange(self.n_cams, dtype=np.int64) * self.n_cams
            + np.arange(self.n_cams)
        ).astype(np.int64)
        # BSR structure: slots are already sorted by (row cam, col cam)
        self.bsr_cols = (slots % self.n_cams).astype(np.int32)
        rows = slots // self.n_cams
        self.bsr_indptr = np.searchsorted(
            rows, np.arange(self.n_cams + 1)
        ).astype(np.int32)

    # ---------------- device assembly ---------------- #

    def assemble(self, jac_e, jac_f, ete_solver, ftf_cam):
        """S block values [n_slots, tf, tf]: diag(F'F + dsq) - corrections.

        ftf_cam: transposed [tf*tf, n_cams] table (jacobian.py layout).
        """
        tf, te = self.tf, self.te
        dtype = jac_f._dtype()
        acc = jnp.zeros((self.n_slots, tf * tf), dtype)
        inv_e = ete_solver.inv_tables[self.e_cls]  # [te*te, cnt]
        for ch in self.chunks:
            gi, fv, d, r = ch["gi"], ch["fv"], ch["d"], ch["r"]
            n_pad = jac_f._group_n(gi)
            e_flat = jac_e.jac_groups[gi][0]
            f_flat = jac_f.jac_groups[gi][fv]
            m = ch["obs"].shape[0]
            ej = _gather_rows(e_flat, n_pad, r * te, ch["obs"]).reshape(
                m, d, r, te
            )
            fj = _gather_rows(f_flat, n_pad, r * tf, ch["obs"]).reshape(
                m, d, r, tf
            )
            w = jnp.einsum("mdre,mdrf->mdef", ej, fj)
            # pair correction w_a^T M^{-1} w_b via the precomputed inverse
            minv = jnp.take(inv_e.T, jnp.asarray(ch["pts"]), axis=0).reshape(
                m, te, te
            )
            minvw = jnp.einsum("mab,mdbf->mdaf", minv, w)
            y_pairs = w.reshape(m * d, te, tf)
            z_pairs = minvw.reshape(m * d, te, tf)
            sa, sb, slot = ch["src_a"], ch["src_b"], ch["slot"]
            for p0 in range(0, sa.size, PAIR_CHUNK):
                sl = slice(p0, p0 + PAIR_CHUNK)
                ya = jnp.take(y_pairs, jnp.asarray(sa[sl]), axis=0)
                yb = jnp.take(z_pairs, jnp.asarray(sb[sl]), axis=0)
                blocks = jnp.einsum("pet,peu->ptu", ya, yb).reshape(
                    -1, tf * tf
                )
                acc = acc + jax.ops.segment_sum(
                    blocks, jnp.asarray(slot[sl]), num_segments=self.n_slots
                )
        s_blocks = (-acc).reshape(self.n_slots, tf, tf)
        s_blocks = s_blocks.at[jnp.asarray(self.diag_slots)].add(
            ftf_cam.T.reshape(-1, tf, tf)
        )
        return s_blocks

    # ---------------- host factor + solve ---------------- #

    def host_solve(self, s_blocks, rhs_cam):
        """Factor block-sparse S with SuperLU, solve for the camera part.
        s_blocks [n_slots, tf, tf], rhs_cam [n_cams * tf]."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        tf = self.tf
        s = sp.bsr_matrix(
            (
                np.asarray(s_blocks, dtype=np.float64),
                self.bsr_cols,
                self.bsr_indptr,
            ),
            shape=(self.n_cams * tf, self.n_cams * tf),
        ).tocsc()
        lu = spla.splu(s)
        return lu.solve(np.asarray(rhs_cam, dtype=np.float64))


def solve_sparse_schur(program, options, jac_s, res_groups, grad_s, dsq):
    """SPARSE_SCHUR linear solve (eager; crosses to host for the factor).

    Same contract as schur.schur_solve: returns (step [num_eff], iters).
    """
    from .schur import make_ete_solver, schur_views

    dtype = grad_s.dtype
    e_mask_np, f_mask_np = program.schur_tangent_masks()
    e_mask = jnp.asarray(e_mask_np, dtype=dtype)
    f_mask = jnp.asarray(f_mask_np, dtype=dtype)

    jac_e, jac_f = schur_views(program, jac_s)
    # the pair-block assembly reads raw [r*t, n] leaves; fold scaling in
    jac_e = jac_e.materialize_scale()
    jac_f = jac_f.materialize_scale()
    dsq_e = dsq * e_mask
    dsq_f = dsq * f_mask
    g_e = grad_s * e_mask
    g_f = grad_s * f_mask

    ete = make_ete_solver(program, jac_e, dsq_e)
    plan = ExplicitSchurPlan.get(program, jac_e, jac_f)

    # rhs = -g_f + F^T E M^{-1} g_e  (schur.schur_solve)
    t2 = ete(g_e)
    et2 = jac_e.right_multiply(t2)
    rhs = -g_f + jac_f.left_multiply(et2)

    ftf = jac_f.block_diag_jtj(dsq=dsq_f)[plan.cam_cls]
    s_blocks = plan.assemble(jac_e, jac_f, ete, ftf)

    base = int(program.tangent_class_bases[plan.cam_cls])
    ncoord = plan.n_cams * plan.tf
    rhs_cam = np.asarray(rhs)[base : base + ncoord]
    x_cam = plan.host_solve(np.asarray(s_blocks), rhs_cam)

    dx_f = jnp.zeros_like(grad_s)
    dx_f = dx_f.at[base : base + ncoord].set(
        jnp.asarray(x_cam, dtype=dtype)
    )
    dx_f = dx_f * f_mask

    # back-substitute e-part: dx_e = -M^{-1} (g_e + E^T F dx_f)
    fdx = jac_f.right_multiply(dx_f)
    etfdx = jac_e.left_multiply(fdx)
    dx_e = -ete(g_e + etfdx) * e_mask
    return dx_f + dx_e, jnp.asarray(1, jnp.int32)
