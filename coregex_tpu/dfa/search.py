"""Bidirectional DFA search primitives — host (numpy) reference semantics.

These define the exact algorithms the device kernels mirror (ops/dfa_scan.py):
forward unanchored break-at-match scan for the leftmost-first match END
(dfa/lazy/lazy.go:1102 SearchAt analogue), bounded reverse anchored scan for
the match START (dfa/lazy/lazy.go:1769 SearchReverse analogue), and the
earliest-match IsMatch scan (lazy.go:530-561 analogue).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .dense import CTX_SOT, DEAD, DenseDFA


def find_fwd_end(fwd: DenseDFA, data: np.ndarray, pos: int = 0) -> int:
    """Leftmost-first match END for a search starting at `pos`, or -1.

    `fwd` must be unanchored + break-at-match (or anchored for ^-patterns).
    """
    n = len(data)
    s = fwd.start_for_context(int(data[pos - 1]) if pos > 0 else None)
    delta, match_on, classes = fwd.delta, fwd.match_on, fwd.classes
    last = -1
    for p in range(pos, n):
        c = classes[data[p]]
        if match_on[s, c]:
            last = p
        s = delta[s, c]
        if s == DEAD:
            return last
    if fwd.match_eoi[s, CTX_SOT]:
        last = n
    return last


def earliest_end(fwd: DenseDFA, data: np.ndarray, pos: int = 0) -> int:
    """First offset ≥ pos where any match ends, or -1 (IsMatch core)."""
    n = len(data)
    s = fwd.start_for_context(int(data[pos - 1]) if pos > 0 else None)
    delta, match_on, classes = fwd.delta, fwd.match_on, fwd.classes
    for p in range(pos, n):
        c = classes[data[p]]
        if match_on[s, c]:
            return p
        s = delta[s, c]
        if s == DEAD:
            return -1
    return n if fwd.match_eoi[s, CTX_SOT] else -1


def find_rev_start(rev: DenseDFA, data: np.ndarray, pos: int,
                   end: int) -> int:
    """Earliest match START in [pos, end] for a match ending exactly at
    `end`, or -1.  `rev` is the anchored reverse DFA (break-at-match off).

    Scans data[end-1] .. data[pos] backward; the scan-entry context is the
    byte at `end` (or true EOI), and the window-edge context at `pos` is the
    byte at pos-1 (or true SOT) — resolving \b / ^ / $ exactly at both
    boundaries.
    """
    s = rev.start_for_context(int(data[end]) if end < len(data) else None)
    delta, match_on, classes = rev.delta, rev.match_on, rev.classes
    last = -1  # reverse offset of last flag
    q = 0
    for p in range(end - 1, pos - 1, -1):
        c = classes[data[p]]
        if match_on[s, c]:
            last = q
        s = delta[s, c]
        if s == DEAD:
            return end - last if last >= 0 else -1
        q += 1
    edge_ctx = rev.context_of(int(data[pos - 1]) if pos > 0 else None)
    if rev.match_eoi[s, edge_ctx]:
        last = q
    return end - last if last >= 0 else -1


def find_span(fwd: DenseDFA, rev: DenseDFA, data: np.ndarray,
              pos: int = 0) -> Optional[Tuple[int, int]]:
    """Leftmost-first span for a search starting at pos (the two-pass
    bidirectional core, meta/findall.go:216-239 analogue)."""
    e = find_fwd_end(fwd, data, pos)
    if e < 0:
        return None
    s = find_rev_start(rev, data, pos, e)
    assert s >= 0, "reverse scan must find a start for a found end"
    return (s, e)


def anchored_last_end(fwd_anchored: DenseDFA, data: np.ndarray, start: int,
                      limit: Optional[int] = None) -> int:
    """Last (longest / leftmost-first-greedy) match end for an anchored scan
    from `start`, or -1.  With a break-at-match anchored DFA this is the
    leftmost-first end from that start; with break-at-match off it is the
    POSIX longest end."""
    n = len(data) if limit is None else limit
    s = fwd_anchored.start_for_context(
        int(data[start - 1]) if start > 0 else None)
    delta, match_on, classes = (fwd_anchored.delta, fwd_anchored.match_on,
                                fwd_anchored.classes)
    last = -1
    for p in range(start, n):
        c = classes[data[p]]
        if match_on[s, c]:
            last = p
        s = delta[s, c]
        if s == DEAD:
            return last
    edge = fwd_anchored.context_of(int(data[n]) if n < len(data) else None)
    if fwd_anchored.match_eoi[s, edge]:
        last = n
    return last
