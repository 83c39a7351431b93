"""Forward span-event scan: the count transducer emitting flag-word
streams.

The count transducer (dfa/countdfa.py) linearizes Go's FindAll restart
walk into one weighted DFA; its tables carry per-transition FLAG /
FIRST-FLAG event bits (valid when `spans_simple`).  This module scans a
corpus through those tables with the transducer kernel in "events" mode
(ops/transducer.py) and emits, besides the match count:

  * flagw  — int32 words, bit p = "a candidate match END at position p"
  * firstw — subset marking each group's FIRST flag (group boundaries)

Downstream (meta/batch.py:_bidi_spans_dev) the flag events compact into
a hit-sized stream; each group's last flag is a committed match end
(plus the EOI kind at the scan's final state), and a reverse-anchored
reset scan recovers the starts — the reference's 2-pass bidirectional
FindAll fast path (meta/findall.go:216-239).

Packing: value = delta*32 + (commits<<2 | first<<1 | flag); commits per
transition are <= SPAN_EMIT_LIMIT = 7 whenever spans_simple.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_SOT
from . import transducer as tx
from .count_scan import guess_entries


class DeviceSpanDFA:
    """Span-event tables uploaded once: the flat packed table with
    value = delta*32 + (commits<<2 | first<<1 | flag), the byte -> class
    map, and the EOI commit/kind tables."""

    def __init__(self, cd: CountDFA):
        if not cd.spans_simple or cd.flag_on is None:
            raise ValueError("span scan requires spans_simple tables")
        self.cd = cd
        self.S, self.C = (int(x) for x in cd.delta.shape)
        emit5 = (cd.flag_on.astype(np.int32)
                 | (cd.first_on.astype(np.int32) << 1)
                 | (cd.emit.astype(np.int32) << 2))
        packed = cd.delta.astype(np.int32) * 32 + emit5
        self.table = jnp.asarray(packed.reshape(-1))
        self.cmap = jnp.asarray(np.asarray(cd.classes, dtype=np.int32))
        self.starts = jnp.asarray(cd.starts, dtype=jnp.int32)
        self.eoi = jnp.asarray(cd.eoi_commits, dtype=jnp.int32)
        self.eoi_kind = jnp.asarray(cd.eoi_kind, dtype=jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("L", "T", "W", "C", "impl", "max_repair"))
def _span_full(table, cmap, starts_tbl, eoi, eoi_kind, data_u8, tiles, n,
               L: int, T: int, W: int, C: int, impl: str,
               max_repair: int = 4):
    """Returns (flag words [L*T/32] position-major with bits >= n
    masked, first words likewise, event count, total match count incl.
    EOI, eoi kind at the final state, converged)."""
    n = jnp.int32(n)
    sot = starts_tbl[CTX_SOT]
    entries0 = guess_entries(starts_tbl, data_u8, L, T, W).at[0].set(sot)
    real = (jnp.arange(L, dtype=jnp.int32) * T) < n
    out, converged = tx.stitch(
        impl, "events", table, cmap, entries0, tx.first_lane_offsets(L, W),
        tx.lane_limits(n, L, T), tx.warm_window(tiles, W), tiles, C, sot,
        real, W, max_repair=max_repair)
    fw, gw, cnts, exits, _ = out
    lane_n = jnp.where(n % T == 0, n // T - 1, n // T)
    state_n = exits[jnp.clip(lane_n, 0, L - 1)]
    total = cnts.sum(dtype=jnp.int32) + eoi[state_n, CTX_SOT]
    kind = eoi_kind[state_n, CTX_SOT]
    fwg = tx.positions_major(fw, n)
    gwg = tx.positions_major(gw, n)
    n_events = jax.lax.population_count(fwg).sum(dtype=jnp.int32)
    return fwg, gwg, n_events, total, kind, converged


class SpanScanner:
    """Per-pattern forward span-event pipeline.

    scan(data_dev) -> (flag words, first words, event count, total
    match count, eoi kind, converged) — all device, one fused dispatch
    over the cached corpus word tiles (shared with CountScanner)."""

    def __init__(self, cd: CountDFA, impl: Optional[str] = None):
        self.dsd = DeviceSpanDFA(cd)
        self.cd = cd
        self.impl = impl or tx.default_impl()

    def scan(self, data_dev: jnp.ndarray,
             geometry: Optional[Tuple[int, int, int]] = None):
        n = int(data_dev.shape[0])
        L, T, W = geometry or tx.plan_geometry(n)
        d = self.dsd
        tiles = tx.corpus_word_tiles(data_dev, L, T)
        return _span_full(
            d.table, d.cmap, d.starts, d.eoi, d.eoi_kind, data_dev, tiles,
            jnp.int32(n), L=L, T=T, W=W, C=d.C, impl=self.impl)
