"""Batched many-strings scan: one launch over a padded [B, L] row matrix.

The reference optimizes "match one pattern against millions of short
strings" with per-call engines plus anchored fast paths — a first-byte
branch dispatch table (nfa/branch_dispatch.go:18-40) and a possible-first
-byte set for O(1) anchored rejection (nfa/firstbytes.go:8-41).  Both are
scalar-branch designs; the data-parallel form subsumes them: step the dense
DFA over ALL rows in lockstep (state vector [B], one gather per column),
so every row's first byte is "dispatched" by the same table lookup that
rejects impossible rows (delta[start, c] == DEAD after one step — the
FirstByteSet rejection, for free).

Row semantics: each row is its own text (SOT context at column 0, true
EOI at its own length).  Padding bytes beyond a row's length never
contribute: positional flags are masked by `t < len`, and the
end-of-text match is evaluated from the state captured at `t == len`
via match_eoi.

Kernels:
  rows_match  — per-row "any match" flags + leftmost-first (last-flag)
                anchored ends: IsMatch / anchored Find in one pass.
  rows_rev_start — per-row match starts for known ends: the batched
                reverse-anchored pass of the two-pass bidirectional find.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..dfa.dense import CTX_SOT, DEAD


def _pad_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def pack_rows(texts: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad byte strings into a [B, L] uint8 matrix + [B] lengths.
    B and L round up to power-of-two buckets so repeat calls with similar
    batches reuse one compiled executable."""
    B = _pad_pow2(max(1, len(texts)))
    L = _pad_pow2(max(1, max((len(t) for t in texts), default=1)))
    rows = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, t in enumerate(texts):
        rows[i, :len(t)] = np.frombuffer(bytes(t), dtype=np.uint8)
        lens[i] = len(t)
    return rows, lens


@functools.partial(__import__("jax").jit, static_argnames=())
def _rows_scan(delta, match_on, match_eoi, starts, classes, rows, lens):
    """Column-lockstep DFA scan.  Returns (found[B], last_end[B]) where
    last_end is the last in-bounds flag position (or the row length when
    match_eoi fires at the row's own end), -1 if none."""
    import jax
    import jax.numpy as jnp
    B, L = rows.shape
    cls = classes[rows]                      # [B, L]
    s0 = jnp.full((B,), starts[CTX_SOT], dtype=jnp.int32)

    def step(carry, xc):
        s, last, eoi_hit = carry
        c, t = xc
        in_bounds = t < lens
        flag = match_on[s, c] & in_bounds
        last = jnp.where(flag, t, last)
        # state at t == len is the end-of-row state: latch its EOI match
        at_end = t == lens
        eoi_hit = eoi_hit | (at_end & match_eoi[s, CTX_SOT])
        ns = jnp.where(in_bounds, delta[s, c], s)
        return (ns, last, eoi_hit), None

    ts = jnp.arange(L, dtype=jnp.int32)
    (s, last, eoi_hit), _ = jax.lax.scan(
        step, (s0, jnp.full((B,), -1, jnp.int32),
               jnp.zeros((B,), bool)), (cls.T, ts), unroll=4)
    # rows whose length == L never hit the at_end latch inside the loop
    eoi_hit = eoi_hit | ((lens == L) & match_eoi[s, CTX_SOT])
    last = jnp.where(eoi_hit, jnp.maximum(last, lens), last)
    return last >= 0, last


@functools.partial(__import__("jax").jit, static_argnames=())
def _rows_rev_scan(delta, match_on, match_eoi, starts, classes, rows,
                   ends):
    """Backward anchored-reverse scan per row: for each row with a match
    ending at ends[b] (< 0: skip), return the earliest match start.
    Entry context is the byte at `end` (or true EOI when end == len);
    here `ends` rows are full matches of their own text, so the edge
    context at position 0 is SOT."""
    import jax
    import jax.numpy as jnp
    B, L = rows.shape
    run = ends >= 0
    end = jnp.maximum(ends, 0)
    # entry context: byte at `end` if end < len else true EOI — callers
    # pass ctx-resolved start states instead when needed; for whole-row
    # finds the byte at `end` is padding == row end, so EOI context
    s0 = starts  # [B] precomputed start states per row
    zero = jnp.zeros((B,), jnp.int32)

    def step(carry, t):
        s, last = carry
        p = end - 1 - t                       # position scanned this step
        live = run & (p >= 0)
        b = rows[jnp.arange(B), jnp.maximum(p, 0)]
        c = classes[b]
        flag = match_on[s, c] & live
        last = jnp.where(flag, t, last)
        ns = jnp.where(live, delta[s, c], s)
        return (ns, last), None

    ts = jnp.arange(L, dtype=jnp.int32)
    (s, last), _ = jax.lax.scan(
        step, (s0, jnp.full((B,), -1, jnp.int32)), ts, unroll=4)
    # window edge at position 0 == true SOT; a flag at reverse offset q
    # means the match starts at end - q (find_rev_start, dfa/search.py:55)
    eoi = match_eoi[s, CTX_SOT] & run
    last = jnp.where(eoi, jnp.maximum(last, end), last)
    return jnp.where(run & (last >= 0), end - last, zero - 1)


class RowBatch:
    """Per-pattern batched rows matcher."""

    def __init__(self, fwd_dense, rev_dense=None, anchored: bool = False):
        import jax.numpy as jnp
        self.anchored = anchored
        self.fwd = fwd_dense
        self.rev = rev_dense
        self._f = {
            k: jnp.asarray(getattr(fwd_dense, k))
            for k in ("delta", "match_on", "match_eoi", "starts")}
        self._f["classes"] = jnp.asarray(
            fwd_dense.classes.astype(np.int32))
        if rev_dense is not None:
            self._r = {
                k: jnp.asarray(getattr(rev_dense, k))
                for k in ("delta", "match_on", "match_eoi", "starts")}
            self._r["classes"] = jnp.asarray(
                rev_dense.classes.astype(np.int32))

    def match_ends(self, rows: np.ndarray, lens: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        import jax
        f = self._f
        found, ends = _rows_scan(f["delta"], f["match_on"],
                                 f["match_eoi"], f["starts"],
                                 f["classes"], rows, lens)
        return jax.device_get(found), jax.device_get(ends)

    def rev_starts(self, rows: np.ndarray, lens: np.ndarray,
                   ends: np.ndarray) -> np.ndarray:
        """Match starts for rows with known ends (two-pass find)."""
        import jax
        import jax.numpy as jnp
        r = self._r
        from ..dfa.dense import DenseDFA
        # entry context per row = byte at `end` (padding/EOI when end==len)
        B = rows.shape[0]
        e = np.maximum(ends, 0)
        at_eoi = e >= lens
        nxt = rows[np.arange(B), np.minimum(e, rows.shape[1] - 1)]
        ctx = np.array([DenseDFA.context_of(None if at_eoi[b]
                                            else int(nxt[b]))
                        for b in range(B)], dtype=np.int32)
        s0 = jnp.asarray(self.rev.starts[ctx].astype(np.int32))
        starts = _rows_rev_scan(r["delta"], r["match_on"], r["match_eoi"],
                                s0, r["classes"], jnp.asarray(rows),
                                jnp.asarray(ends))
        return jax.device_get(starts)
