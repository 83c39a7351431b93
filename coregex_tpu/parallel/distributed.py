"""Multi-host execution plumbing (SURVEY.md §2.9/§6: ≥2-host scaling).

The single-process layer (parallel/shard.py) already expresses the
two-phase exact sharded scan as SPMD over a Mesh; this module makes the
same programs run across HOSTS:

  * `initialize()` wraps jax.distributed.initialize — after it,
    jax.devices() is the global device set and every jitted shard_map
    program runs SPMD across processes (collectives ride ICI within a
    slice and DCN across hosts).
  * `global_mesh()` / `hybrid_mesh()` build the mesh over all global
    devices; the hybrid variant keeps a separate DCN (host) axis so
    shardings can be laid out with the sequence axis on ICI and only
    the final psum crossing DCN — the scaling-book recipe.
  * `distributed_count()` runs the exact two-phase sharded count
    (shard.py:make_sharded_count) on per-process local corpus shards:
    each host contributes its local bytes via
    jax.make_array_from_process_local_data, phase-1 transfer functions
    all_gather globally, and the psum'd count is replicated back.

The reference has no distributed layer at all (SURVEY §2.9: verified no
networking imports); the capability target here is its FindAll/Count
semantics at multi-host corpus scale.  Tested with a real multi-process
CPU cluster in tests/test_multihost.py (the fake-backend strategy of
SURVEY §4 item 5).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed (idempotent).  Returns True when
    running multi-process after the call.  With no arguments, relies on
    the environment (cluster metadata / JAX_COORDINATOR_ADDRESS etc.);
    single-process environments return False without error."""
    # do not touch jax.process_count()/devices() first: they initialize
    # the XLA backend, after which distributed.initialize refuses to run
    try:
        from jax._src.distributed import global_state
        if getattr(global_state, "client", None) is not None:
            return jax.process_count() > 1  # already initialized
    except Exception:
        pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except Exception:
        if coordinator_address is not None:
            raise
        return jax.process_count() > 1
    return jax.process_count() > 1


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every global device (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def hybrid_mesh(dcn_axis: str = "hosts", ici_axis: str = "data") -> Mesh:
    """2-D (hosts × per-host devices) mesh: shard the sequence over the
    ICI axis and keep cross-host traffic to the small DCN reductions.
    Falls back to a 1×N mesh in single-process environments."""
    nproc = jax.process_count()
    devs = jax.devices()
    per = len(devs) // max(nproc, 1)
    if nproc > 1 and per * nproc == len(devs):
        try:
            from jax.experimental import mesh_utils
            arr = mesh_utils.create_hybrid_device_mesh(
                (per,), (nproc,), devices=devs)
            # create_hybrid_device_mesh returns [dcn*ici] ordering with
            # dcn outermost
            return Mesh(arr.reshape(nproc, per), (dcn_axis, ici_axis))
        except Exception:
            pass
    grid = np.array(devs).reshape(max(nproc, 1), -1)
    return Mesh(grid, (dcn_axis, ici_axis))


def make_global_corpus(mesh: Mesh, local_data: np.ndarray,
                       axis: str = "data"):
    """Assemble a globally-sharded corpus array from this process's
    local shard (every process holds an equal-length slice, in process
    order).  Single-process meshes just upload the array."""
    sh = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        import jax.numpy as jnp
        return jax.device_put(jnp.asarray(local_data), sh)
    return jax.make_array_from_process_local_data(sh, local_data)


def distributed_count(ddfa, local_data: np.ndarray,
                      mesh: Optional[Mesh] = None, axis: str = "data"
                      ) -> int:
    """Exact all-match-ends count over a multi-host-sharded corpus via
    the two-phase transfer-function scan.  `local_data` is THIS
    process's equal-length shard; its length must be divisible by the
    number of local devices (global length by the mesh size).  The
    returned count is identical on every process."""
    from .shard import make_sharded_count
    mesh = mesh or global_mesh(axis)
    fn = make_sharded_count(mesh, ddfa, axis=axis, vector_out=True)
    garr = make_global_corpus(mesh, local_data, axis)
    out = fn(garr)  # [D], every entry the psum'd total
    return int(np.asarray(jax.device_get(out.addressable_data(0)))[0])
