"""Stream compaction: positions of set entries of a giant mask, on device.

The primitive of every span-extraction path (run starts/ends, literal
hits, candidate sets and transducer events all reduce to "positions of
set bits").  One inclusive cumsum gives each hit its rank; a scatter
writes the positions.  Both are memory-bound
parallel passes on the GPU.  The reference has no analogue (its outputs
are CPU-resident appends, e.g. meta/findall.go:176-283).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import jax


def _compact_xla(mask8, cap: int):
    """(int32[cap] ascending positions padded with n, int32 count)."""
    n = mask8.shape[0]
    m = mask8 != 0
    cum = jnp.cumsum(m.astype(jnp.int32))
    idx = jnp.where(m, cum - 1, cap)
    out = jnp.full(cap, n, dtype=jnp.int32)
    out = out.at[idx].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    return out, cum[-1] if n else jnp.int32(0)


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_xla_jit(mask8, cap: int):
    return _compact_xla(mask8, cap)


def compact_positions(mask, cap: int):
    """Positions of set entries of `mask` (any int/bool dtype, 1-D),
    ascending, as (int32[cap] padded with the sentinel n, int32 count)."""
    if int(mask.shape[0]) == 0:
        return jnp.full(cap, 0, jnp.int32), jnp.int32(0)
    return _compact_xla_jit(mask.astype(jnp.int8), cap)
