"""Flag-word-emitting reset scan.

The reset-scan semantics of dfa_scan._chunk_scan_reset run through the
transducer kernel (ops/transducer.py, "flags" mode) by moving the reset
bit into the ALPHABET:

    symbol  = 2*byte_class + reset_bit          (u8, <= 2C <= 128)
    delta'  [s, sym] = delta[rs ? start : s, cls]
    emit'   [s, sym] = match_on[rs ? start : s, cls]   (bit 0)
                     | (rs & s != DEAD) << 1            (bit 1: interference)

and the kernel, instead of summing emissions, PACKS bit 0 into int32
flag words (32 positions per word) — the exact input the span chains
consume — while bit 1 accumulates into the lane counters (any
interference -> caller falls back).  The reset context (start-state
column) is a compile-time constant: INNER resets fire right after a
fixed literal, so the context byte is known.

Flags match dfa_scan._chunk_scan_reset exactly: flag at p =
match_on[s_pre(p), cls(p)], states freeze past the limit, and the flag
at offset n (first pad symbol) doubles as lookfree EOI acceptance
(meta/batch.py:_flags_with_eoi).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dfa.dense import DEAD
from . import transducer as tx


class ResetFlagTables:
    """Extended-alphabet tables for a DeviceDFA + constant reset
    context, packed for the transducer kernel.

    flag_pre_reset=True evaluates the flag at a reset position against
    the OLD run's state instead of the fresh start (the transition
    still resets): the bidirectional span path's reverse scan needs the
    boundary flag "match start exactly at the previous match's end",
    which the reset would otherwise mask (meta/batch.py:_bidi_spans_dev).
    Interference accounting is dropped in this mode — truncating a live
    run at a reset is the expected behavior there, not a failure."""

    def __init__(self, ddfa, reset_ctx: int,
                 flag_pre_reset: bool = False):
        delta = np.asarray(ddfa.delta)
        match = np.asarray(ddfa.match_on)
        starts = np.asarray(ddfa.host_starts)
        S, C = delta.shape
        if C > 64:
            raise ValueError("flag scan packs 2C symbols in u8: C <= 64")
        start = int(starts[reset_ctx])
        NSEG = 2 * C
        de = np.zeros((S, NSEG), dtype=np.int32)
        ee = np.zeros((S, NSEG), dtype=np.int32)
        for rs in (0, 1):
            for s in range(S):
                s_pre = start if rs else s
                s_flag = s if (rs and flag_pre_reset) else s_pre
                de[s, 2 * np.arange(C) + rs] = delta[s_pre]
                ee[s, 2 * np.arange(C) + rs] = (
                    match[s_flag].astype(np.int32)
                    | ((rs and s != DEAD and not flag_pre_reset) << 1))
        packed = de * 32 + ee
        self.S, self.NSEG = S, NSEG
        self.table = jnp.asarray(packed.reshape(-1))
        self.bounds = np.asarray(ddfa.bounds)  # host byte-seg bounds


# ---------------------------------------------------------------------------
# Symbols (byte class + reset bit), one fused pass
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("bounds",))
def reset_symbols(dev, rmask, bounds: Tuple[int, ...]):
    """u8 symbol stream 2*cls + reset, with 32 pad symbols appended so
    position n always exists in the tiled stream (EOI flag)."""
    cls = jnp.zeros(dev.shape, dtype=jnp.int32)
    for b in bounds:
        cls = cls + (dev >= np.uint8(b)).astype(jnp.int32)
    sym = (2 * cls + rmask.astype(jnp.int32)).astype(jnp.uint8)
    return jnp.concatenate([sym, jnp.zeros(32, dtype=jnp.uint8)])


def reset_geometry(n: int):
    """Shared geometry for a [n+32]-symbol reset scan (the tile cache
    and scan_tiles must agree)."""
    return tx.plan_geometry(n + 32)


@functools.partial(jax.jit, static_argnames=("bounds", "L", "T4"))
def _sym_base_tiles(dev, bounds: Tuple[int, ...], L: int, T4: int):
    """Reset-FREE symbol word tiles (2*cls) for a corpus: cacheable per
    (corpus, tables) — per-call reset bits scatter into a copy in the
    TILE domain (see scatter_reset_tiles), skipping the corpus-sized
    u8 symbol array and its per-call tile build entirely."""
    cls = jnp.zeros(dev.shape, dtype=jnp.uint8)
    for b in bounds:
        cls = cls + (dev >= np.uint8(b)).astype(jnp.uint8)
    sym = cls * np.uint8(2)
    sym = jnp.concatenate([sym, jnp.zeros(32, dtype=jnp.uint8)])
    return tx.make_word_tiles(sym, L, T4)


@functools.partial(jax.jit, static_argnames=("L", "T4"))
def scatter_reset_tiles(base_tiles, rq, L: int, T4: int):
    """Copy of the cached symbol tiles with the reset bit (+1 on even
    symbol bytes: no carries) scattered at positions rq (int32 dropped
    when out of range).  Tile layout: word w = pos>>2 lives at flat
    index (w % T4) * L + (w // T4) with byte lane pos & 3
    (transducer.make_word_tiles)."""
    w = rq >> 2
    # dead lanes carry rq = -1 (negative: at the 1.6 GB bucket every
    # positive int32 is an in-range position); keep them negative so
    # mode="drop" discards them
    flat = jnp.where((rq >= 0) & (rq < jnp.int32(L * T4 * 4)),
                     (w % T4) * L + (w // T4), jnp.int32(-1))
    val = jnp.left_shift(jnp.int32(1), 8 * (rq & 3))
    out = base_tiles.reshape(-1).at[flat].add(val, mode="drop")
    return out.reshape(base_tiles.shape)


# ---------------------------------------------------------------------------
# Full scan: warmup guess + boundary-repair fixpoint, one jit
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("L", "T", "W", "NSEG", "impl", "max_repair"))
def _flag_full(table, tiles, n1, entries_init, L: int, T: int, W: int,
               NSEG: int, impl: str, max_repair: int = 4):
    """Returns (flag words [L*T/32] position-major, interference count,
    converged, lane entry states).  n1 = n + 1 (the EOI position is
    live).  entries_init: lane entry guesses — DEAD for a fresh scan
    (resets inside the warmup window resync), or a previous converged
    scan's entries (states AT lane starts; warmup is then skipped and
    the fixpoint check passes in one pass)."""
    n1 = jnp.int32(n1)
    is_hint = jnp.any(entries_init != DEAD)
    # hinted entries are states AT lane starts: skip the warmup window
    # entirely (offsets == W), matching the repair passes
    offsets0 = jnp.where(is_hint, jnp.full((L,), W, jnp.int32),
                         tx.first_lane_offsets(L, W))
    real = (jnp.arange(L, dtype=jnp.int32) * T) < n1
    dead = jnp.int32(DEAD)
    out, converged = tx.stitch(
        impl, "flags", table, None, entries_init, offsets0,
        tx.lane_limits(n1, L, T), tx.warm_window(tiles, W), tiles, NSEG,
        dead, real, W, max_repair=max_repair)
    fw, cnts, exits, _ = out
    hint = jnp.concatenate([dead[None], exits[:-1]])
    # mask bits past n (= n1-1): the automaton keeps walking pad
    # symbols, but only the EOI bit at n is meaningful
    return (tx.positions_major(fw, n1), cnts.sum(dtype=jnp.int32),
            converged, hint)


class FlagResetScanner:
    """Reset-scan with flag-WORD output through the transducer kernel.

    scan_words(dev, rmask, n) -> (flag words over the [n+1] domain
    [ceil((n+1)/32) padded], interference count, converged) — all
    device; one fused dispatch after the symbol/tile build."""

    def __init__(self, ddfa, reset_ctx: int, impl=None,
                 flag_pre_reset: bool = False):
        self.tables = ResetFlagTables(ddfa, reset_ctx,
                                      flag_pre_reset=flag_pre_reset)
        self.impl = impl or tx.default_impl()

    def byte_bounds(self) -> Tuple[int, ...]:
        """Byte segment boundaries for the symbol build (producers can
        fuse reset_symbols into their own pass)."""
        return tuple(int(b) for b in self.tables.bounds
                     if 0 < int(b) < 256)

    def scan_words(self, dev, rmask):
        syms = reset_symbols(dev, rmask, self.byte_bounds())
        return self.scan_words_syms(syms, int(dev.shape[0]))

    def scan_words_syms(self, syms, n: int, entries_hint=None):
        """As scan_words but from a prebuilt symbol stream (length
        n + pad >= n+1; see reset_symbols).

        `entries_hint`: [L] int32 lane entry states from a previous
        converged scan of the SAME symbol stream.  Reset-scan lanes
        enter as DEAD and only resync at a reset, so when resets are
        sparse (the bidirectional span path) the first pass always pays
        one repair rescan; with the hint the fixpoint check passes
        immediately and the scan costs one pass.  Exactness is
        unaffected — the repair loop validates the hint like any other
        guess.  Returns (flag words, interference, converged, entries);
        cache `entries` as the next call's hint."""
        L, T, W = tx.plan_geometry(int(syms.shape[0]))
        tiles = tx.make_word_tiles(syms, L, T // 4)
        return self._scan_geom(tiles, n, (L, T, W), entries_hint)

    def scan_tiles(self, tiles, n: int, entries_hint=None):
        """As scan_words_syms but from prebuilt SYMBOL WORD TILES under
        reset_geometry(n) — the bidirectional span path caches the
        reset-free tiles per corpus and scatters per-call reset bits in
        the tile domain (scatter_reset_tiles), so no corpus-sized
        per-call work remains before the kernel."""
        return self._scan_geom(tiles, n, reset_geometry(n), entries_hint)

    def _scan_geom(self, tiles, n: int, geom, entries_hint):
        L, T, W = geom
        t = self.tables
        if entries_hint is None or int(entries_hint.shape[0]) != L:
            entries_hint = jnp.full((L,), DEAD, jnp.int32)
        return _flag_full(t.table, tiles, n + 1, entries_hint, L=L, T=T,
                          W=W, NSEG=t.NSEG, impl=self.impl)
