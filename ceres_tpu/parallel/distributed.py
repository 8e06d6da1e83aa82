"""Multi-host (multi-process) runtime.

The reference is a single-process library (SURVEY.md §2d: "Communication
backend: none"); this module is the capability the north star adds: several
hosts, each owning a shard of the residual blocks, running the SAME SPMD
solve with cross-host collectives over ICI/DCN.

Design (scaling-book recipe — mesh, shardings, collectives):
- every process calls `initialize()` (jax.distributed), then builds the
  identical Program from global metadata (index arrays are global and
  cheap; the float observation payload can stay host-local via
  io.bal.load_bal_lazy);
- `global_mesh()` spans ALL processes' devices; sharded-array construction
  (parallel.sharding.build_sharded_arrays -> put_global) materializes only
  the rows each process's devices own;
- the solve itself is the ordinary sharded path: every host runs the same
  trust-region control loop; device collectives (psum over the mesh axis)
  cross hosts transparently, and every host-fetched scalar is a fully
  replicated jax.Array, so control flow stays in lockstep.

Launch recipe for BASELINE config 5 (BAL-13682 on N>=2 hosts) is in
docs/distributed.md; the 2-process CPU-emulation test
(tests/test_multiprocess.py) follows SURVEY.md §4:537-539.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
):
    """Join (or auto-detect) a multi-process JAX runtime.

    For CPU emulation (tests) pass them explicitly and set
    `platform="cpu"`, `local_device_count=k` to give each process k
    virtual devices (SURVEY §4:537-539 pattern).
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "dp"):
    """1-D mesh over every device of every process (data-parallel over
    residual blocks, the framework's scaling axis)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def hybrid_mesh(dcn_axis: str = "dcn", ici_axis: str = "ici"):
    """Two-level DCN-aware mesh: one row of fast-interconnect (ICI)
    devices per host, hosts stacked along the DCN axis (SURVEY.md
    §2d:332-339; the jax mesh_utils.create_hybrid_device_mesh shape for a
    flat slice-per-host topology).

    Lanes shard over BOTH axes (PartitionSpec((dcn, ici))); every
    tangent-space reduction then runs two-stage — psum within each host's
    ICI ring first, then one already-reduced value per host crosses DCN
    (jacobian.psum_hierarchical). Pass to SolverOptions.mesh; the sharded
    evaluator detects the 2-axis shape automatically.
    """
    import jax
    from jax.sharding import Mesh

    by_proc: dict = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, []).append(d)
    rows = [
        sorted(v, key=lambda dd: dd.id) for _k, v in sorted(by_proc.items())
    ]
    per = len(rows[0])
    if any(len(r) != per for r in rows):
        raise ValueError(
            "hybrid_mesh requires the same device count on every process"
        )
    return Mesh(np.array(rows, dtype=object), (dcn_axis, ici_axis))


def replicate(x, mesh=None):
    """Turn a host value (same on every process) into a fully replicated
    global jax.Array so it can feed jitted sharded computations."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mesh is None:
        mesh = global_mesh()
    x = np.asarray(x)
    sh = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.device_put(x, sh)
    return jax.make_array_from_process_local_data(sh, x, x.shape)
