"""Multi-chip corpus sharding (jax.sharding.Mesh + shard_map).

The reference is single-process (SURVEY.md §2.9); here corpus sharding is a
first-class subsystem: bytes shard across a 1-D device mesh, compiled DFA
tables replicate, and boundary stitching is *exact* via a two-phase scan:

  phase 1 — every device computes its shard's full state-transfer function
            F: S -> S by scanning an [S]-vector of states (enumerative,
            the blockwise transition-function composition of SURVEY §2.9);
  phase 2 — transfer functions all_gather across devices, each device composes
            its true entry state by folding predecessors' functions, then
            rescans its shard from the exact entry, counting match flags;
            counts reduce with psum.

This is the regex counterpart of blockwise long-context processing: no
overlap, no approximation, two passes total.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dfa.dense import CTX_SOT, DEAD
from ..ops.dfa_scan import DeviceDFA, byte_context


def _local_transfer_fn(delta, cls_shard, S: int):
    """Phase 1: shard's transfer function as an [S] vector (F[s] = state
    after the shard, entering in state s)."""
    def step(F, c):
        return delta[F, c], None
    F0 = jnp.arange(S, dtype=jnp.int32)
    F, _ = jax.lax.scan(step, F0, cls_shard, unroll=4)
    return F


def _local_flag_scan(delta, match_on, cls_shard, entry):
    """Phase 2: scan from the exact entry state, counting match flags."""
    def step(carry, c):
        s, cnt = carry
        cnt = cnt + match_on[s, c].astype(jnp.int32)
        return (delta[s, c], cnt), None
    (fin, cnt), _ = jax.lax.scan(step, (entry, jnp.int32(0)), cls_shard,
                                 unroll=4)
    return fin, cnt


def make_sharded_count(mesh: Mesh, ddfa: DeviceDFA, axis: str = "data",
                       vector_out: bool = False):
    """Build a jitted sharded all-match-ends counter over `mesh`.

    Returns fn(data_u8 [n]) -> total match-end count (int32), with n
    divisible by the mesh size.  Tables replicate; data shards.
    `vector_out` returns the per-shard [D] vector (every entry equals
    the psum'd total) instead of a scalar — multi-process callers read
    their own addressable shard (parallel/distributed.py)."""
    delta, match_on = ddfa.delta, ddfa.match_on
    match_eoi, starts_tbl, classes = ddfa.match_eoi, ddfa.starts, ddfa.classes
    S = ddfa.num_states
    ndev = mesh.shape[axis]

    def body(data_shard, delta, match_on, match_eoi, starts_tbl, classes):
        my = jax.lax.axis_index(axis)
        cls_shard = classes[data_shard]
        # phase 1: transfer function + gather
        F = _local_transfer_fn(delta, cls_shard, S)
        Fs = jax.lax.all_gather(F, axis)              # [D, S]
        # fold predecessors to find the exact entry state
        sot = starts_tbl[CTX_SOT]

        def fold(d, e):
            return jnp.where(d < my, Fs[d][e], e)
        entry = jax.lax.fori_loop(0, ndev, fold, sot)
        # phase 2: exact scan + flag count
        fin, cnt = _local_flag_scan(delta, match_on, cls_shard, entry)
        # EOI flag counted on the last device only
        eoi = jnp.where(my == ndev - 1,
                        match_eoi[fin, CTX_SOT].astype(jnp.int32), 0)
        total = jax.lax.psum(cnt + eoi, axis)
        return total[None]

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=False)

    @jax.jit
    def run(data):
        out = smapped(data, delta, match_on, match_eoi, starts_tbl, classes)
        return out if vector_out else out[0]

    return run


def make_sharded_flags(mesh: Mesh, ddfa: DeviceDFA, axis: str = "data"):
    """Sharded variant returning the full match-end flag mask [n] (host
    post-processing then mirrors the single-chip selection pipeline)."""
    delta, match_on = ddfa.delta, ddfa.match_on
    starts_tbl, classes = ddfa.starts, ddfa.classes
    S = ddfa.num_states
    ndev = mesh.shape[axis]

    def body(data_shard, delta, match_on, starts_tbl, classes):
        my = jax.lax.axis_index(axis)
        cls_shard = classes[data_shard]
        F = _local_transfer_fn(delta, cls_shard, S)
        Fs = jax.lax.all_gather(F, axis)
        sot = starts_tbl[CTX_SOT]

        def fold(d, e):
            return jnp.where(d < my, Fs[d][e], e)
        entry = jax.lax.fori_loop(0, ndev, fold, sot)

        def step(s, c):
            return delta[s, c], match_on[s, c]
        _, flags = jax.lax.scan(step, entry, cls_shard, unroll=4)
        return flags

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=False)

    @jax.jit
    def run(data):
        return smapped(data, delta, match_on, starts_tbl, classes)

    return run


def make_sharded_ends(mesh: Mesh, ddfa: DeviceDFA, cap: int,
                      axis: str = "data"):
    """Sharded match-end discovery with per-shard compaction: each device
    scans its shard from its exact (transfer-fold) entry state and
    compacts its flag offsets into a fixed [cap] buffer (global byte
    offsets, fill = n_pad), plus per-shard counts for overflow detection
    — the fixed-capacity match-buffer protocol of SURVEY.md §5 (ragged
    results are not XLA-friendly).

    Returns fn(data_u8 [n]) -> (positions [D*cap] i32, counts [D] i32);
    n must be divisible by the mesh size.  Positions beyond the true
    corpus length (zero padding added by the caller) must be filtered on
    host; counts > cap mean the shard overflowed (caller falls back)."""
    delta, match_on = ddfa.delta, ddfa.match_on
    starts_tbl, classes = ddfa.starts, ddfa.classes
    S = ddfa.num_states
    ndev = mesh.shape[axis]

    def body(data_shard, delta, match_on, starts_tbl, classes):
        my = jax.lax.axis_index(axis)
        m = data_shard.shape[0]
        cls_shard = classes[data_shard]
        F = _local_transfer_fn(delta, cls_shard, S)
        Fs = jax.lax.all_gather(F, axis)
        sot = starts_tbl[CTX_SOT]

        def fold(d, e):
            return jnp.where(d < my, Fs[d][e], e)
        entry = jax.lax.fori_loop(0, ndev, fold, sot)

        def step(s, c):
            return delta[s, c], match_on[s, c]
        _, flags = jax.lax.scan(step, entry, cls_shard, unroll=4)
        cnt = flags.sum(dtype=jnp.int32)
        (idx,) = jnp.nonzero(flags, size=cap, fill_value=m)
        pos = (idx + my * m).astype(jnp.int32)
        pos = jnp.where(idx == m, jnp.int32(ndev) * m, pos)
        return pos, cnt[None]

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False)

    @jax.jit
    def run(data):
        return smapped(data, delta, match_on, starts_tbl, classes)

    return run


def default_mesh(n_devices: Optional[int] = None, axis: str = "data"
                 ) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# ---------------------------------------------------------------------------
# 2-D mesh: corpus (data) x pattern parallelism
# ---------------------------------------------------------------------------

def pad_and_stack(ddfas) -> Tuple[jnp.ndarray, ...]:
    """Stack several patterns' tables into [P, S, C] arrays (padded), for
    pattern-parallel scanning — the reference's multi-pattern Teddy buckets
    writ large (SURVEY.md §2.9 expert/tensor-parallel analogue)."""
    S = max(d.num_states for d in ddfas)
    C = max(d.num_classes for d in ddfas)
    P_ = len(ddfas)
    delta = np.zeros((P_, S, C), dtype=np.int32)
    match_on = np.zeros((P_, S, C), dtype=bool)
    match_eoi = np.zeros((P_, S, 4), dtype=bool)
    starts = np.zeros((P_, 4), dtype=np.int32)
    classes = np.zeros((P_, 256), dtype=np.int32)
    for i, d in enumerate(ddfas):
        s, c = d.num_states, d.num_classes
        delta[i, :s, :c] = np.asarray(jax.device_get(d.delta))
        match_on[i, :s, :c] = np.asarray(jax.device_get(d.match_on))
        match_eoi[i, :s] = np.asarray(jax.device_get(d.match_eoi))
        starts[i] = np.asarray(jax.device_get(d.starts))
        classes[i] = np.asarray(jax.device_get(d.classes))
    return (jnp.asarray(delta), jnp.asarray(match_on),
            jnp.asarray(match_eoi), jnp.asarray(starts),
            jnp.asarray(classes))


def make_sharded_multi_count(mesh: Mesh, stacked, num_states: int,
                             data_axis: str = "data",
                             pattern_axis: str = "pattern"):
    """Jitted 2-D SPMD step: corpus shards over `data_axis`, pattern tables
    shard over `pattern_axis`; returns per-pattern match-end counts [P].

    This is the framework's flagship multi-chip step: sequence-sharded
    exact DFA scanning (phase-1 transfer functions + all_gather over ICI +
    phase-2 exact rescan) combined with pattern parallelism.
    """
    delta, match_on, match_eoi, starts_tbl, classes = stacked
    S = num_states
    ndev = mesh.shape[data_axis]

    def body(data_shard, delta, match_on, match_eoi, starts_tbl, classes):
        my = jax.lax.axis_index(data_axis)

        def one_pattern(delta_p, match_p, eoi_p, starts_p, classes_p):
            cls_shard = classes_p[data_shard]
            F = _local_transfer_fn(delta_p, cls_shard, S)
            Fs = jax.lax.all_gather(F, data_axis)
            sot = starts_p[CTX_SOT]

            def fold(d, e):
                return jnp.where(d < my, Fs[d][e], e)
            entry = jax.lax.fori_loop(0, ndev, fold, sot)
            fin, cnt = _local_flag_scan(delta_p, match_p, cls_shard, entry)
            eoi = jnp.where(my == ndev - 1,
                            eoi_p[fin, CTX_SOT].astype(jnp.int32), 0)
            return cnt + eoi

        local_counts = jax.vmap(one_pattern)(
            delta, match_on, match_eoi, starts_tbl, classes)
        return jax.lax.psum(local_counts, data_axis)

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(data_axis), P(pattern_axis), P(pattern_axis),
                  P(pattern_axis), P(pattern_axis), P(pattern_axis)),
        out_specs=P(pattern_axis),
        check_vma=False)

    @jax.jit
    def run(data):
        return smapped(data, delta, match_on, match_eoi, starts_tbl, classes)

    return run
