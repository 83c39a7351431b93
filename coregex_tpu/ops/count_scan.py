"""Single-launch corpus count scan for the CountDFA transducer.

The count transducer (dfa/countdfa.py) turns Go's FindAll loop into a
weighted DFA; this module scans a whole corpus through it and returns
(count, converged), all inside one jit:

  * the corpus splits into L lanes of T bytes (ops/transducer.py); each
    lane walks its chunk through the packed [delta|emit] table and sums
    the emissions — the reference's one-gather hot loop
    (dfa/lazy/lazy.go:602-673), one lane per GPU thread;
  * lanes first warm up over the W-byte tail of the previous lane from a
    guessed entry state; an in-jit fixpoint rescans lanes whose state at
    the lane start disagrees with the previous lane's exit, so the
    result is exactly the sequential scan's;
  * the byte stream is packed 4 bytes per int32 word, time-major, and
    cached on device per corpus (transducer.corpus_word_tiles).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD
from . import transducer as tx


class DeviceCountDFA:
    """CountDFA tables uploaded once: the flat packed table
    `table[s * C + c] = delta * 32 + emit` and the 256-entry byte ->
    class map."""

    def __init__(self, cd: CountDFA):
        self.cd = cd
        self.S, self.C = (int(x) for x in cd.delta.shape)
        packed = (cd.delta.astype(np.int32) * 32
                  + cd.emit.astype(np.int32))
        self.table = jnp.asarray(packed.reshape(-1))
        self.cmap = jnp.asarray(np.asarray(cd.classes, dtype=np.int32))
        self.starts = jnp.asarray(cd.starts, dtype=jnp.int32)
        self.eoi = jnp.asarray(cd.eoi_commits, dtype=jnp.int32)


def _byte_ctx(b):
    is_word = (((b >= 48) & (b <= 57)) | ((b >= 65) & (b <= 90))
               | (b == 95) | ((b >= 97) & (b <= 122)))
    return jnp.where(is_word, CTX_WORD,
                     jnp.where(b == 10, CTX_NL, CTX_OTHER))


def guess_entries(starts_tbl, data_u8, L: int, T: int, W: int):
    """Per-lane entry guesses: the start state for the context of the
    byte before each lane's warmup window."""
    guess_pos = jnp.arange(L, dtype=jnp.int32) * T - W - 1
    prev_b = data_u8[jnp.clip(guess_pos, 0, data_u8.shape[0] - 1)
                     ].astype(jnp.int32)
    ctx = _byte_ctx(prev_b)
    return jnp.where(
        guess_pos < 0, starts_tbl[CTX_SOT],
        jnp.where(ctx == CTX_WORD, starts_tbl[CTX_WORD],
                  jnp.where(ctx == CTX_NL, starts_tbl[CTX_NL],
                            starts_tbl[CTX_OTHER])))


def count_lanes(table, cmap, starts_tbl, data_u8, tiles, n, first,
                L: int, T: int, W: int, C: int, impl: str,
                max_repair: int = 4):
    """(emitted count, state at n, converged) of the corpus entered in
    state `first`; traceable (the sharded counter runs it per shard)."""
    n = jnp.asarray(n, jnp.int32)
    entries0 = guess_entries(starts_tbl, data_u8, L, T, W).at[0].set(first)
    limits = tx.lane_limits(n, L, T)
    real = (jnp.arange(L, dtype=jnp.int32) * T) < n
    out, converged = tx.stitch(
        impl, "count", table, cmap, entries0, tx.first_lane_offsets(L, W),
        limits, tx.warm_window(tiles, W), tiles, C, first, real, W,
        max_repair=max_repair)
    counts, exits, _ = out
    lane_n = jnp.where(n % T == 0, n // T - 1, n // T)
    state_n = jnp.where(n > 0, exits[jnp.clip(lane_n, 0, L - 1)], first)
    return counts.sum(dtype=jnp.int32), state_n, converged


_count_lanes_jit = jax.jit(
    count_lanes, static_argnames=("L", "T", "W", "C", "impl", "max_repair"))


class CountScanner:
    """Per-pattern device count pipeline; returns exact Go match counts."""

    def __init__(self, cd: CountDFA, impl: Optional[str] = None):
        self.dcd = DeviceCountDFA(cd)
        self.cd = cd
        self.impl = impl or tx.default_impl()

    def count_from(self, data_dev: jnp.ndarray, first,
                   geometry: Optional[Tuple[int, int, int]] = None):
        """Device (emitted count, state at the end, converged) of the
        corpus entered in state `first`; chaining these over segments
        with the state carried is the sequential scan."""
        n = int(data_dev.shape[0])
        L, T, W = geometry or tx.plan_geometry(n)
        d = self.dcd
        tiles = tx.corpus_word_tiles(data_dev, L, T)
        return _count_lanes_jit(d.table, d.cmap, d.starts, data_dev, tiles,
                                jnp.int32(n), jnp.int32(first), L=L, T=T,
                                W=W, C=d.C, impl=self.impl)

    def count(self, data_dev: jnp.ndarray,
              geometry: Optional[Tuple[int, int, int]] = None
              ) -> Optional[int]:
        """Exact count for the device corpus, or None if boundary repair
        failed to converge (caller falls back)."""
        sot = int(self.cd.starts[CTX_SOT])
        if int(data_dev.shape[0]) == 0:
            return int(self.cd.eoi_commits[sot, CTX_SOT])
        cnt, state_n, conv = jax.device_get(
            self.count_from(data_dev, sot, geometry))
        if not bool(conv):
            return None
        return int(cnt) + int(self.cd.eoi_commits[int(state_n), CTX_SOT])
