"""Device span assembly: aligned start/end mask pairs -> [cap,2] spans.

The span-extraction counterpart of the count kernels: where the
reference appends (start, end) pairs to a CPU vector as its loop walks
(/root/reference/meta/findall.go:176-283), a batch machine builds one
mask of match STARTS and one of match ENDS — in the same fused
cummax/shift style as the count kernels — and compacts both with the
stream compaction of ops/compact.py.  When each match
contributes exactly one bit to each mask, in order, zipping the two
compacted arrays IS the span list; everything stays device-resident
(the span arrays never cross the host link unless the caller asks).

Families covered here: line shapes (first/last-candidate-per-line and
line-bound endpoints) and the multi-literal end-mask builder.  Charclass
runs already have aligned masks (`_run_masks`); candidate families
(INNER / PREFIX_SET / PREFIX_RUN) get device ends from the window
scanner and only use the zip+validate step.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .bytescan import _memmem_mask, line_bound_arrays


@functools.partial(jax.jit, static_argnames=("cap",))
def spans_from_masks(smask, emask, cap: int):
    """Compact an aligned (startmask, endmask) pair into spans.

    Returns (spans [cap,2] int32, count int32, ok bool).  ok verifies
    the alignment invariant ON DEVICE: equal counts and
    start[i] < end[i] <= start[i+1] (strictly increasing non-overlap);
    when ok is False the caller must fall back (the masks describe
    overlapping or mismatched matches).  smask may be [n] or [n+1];
    emask is [n+1] (an exclusive end can be n)."""
    from .compact import compact_positions
    n = smask.shape[0]
    starts, cs = compact_positions(smask, cap)
    ends, ce = compact_positions(emask, cap)
    live = jnp.arange(cap, dtype=jnp.int32) < cs
    ok = cs == ce
    ok &= jnp.all(jnp.where(live, starts < ends, True))
    nxt = jnp.concatenate([starts[1:], jnp.full(1, 2**31 - 1, jnp.int32)])
    live_nxt = jnp.arange(cap, dtype=jnp.int32) < cs - 1
    ok &= jnp.all(jnp.where(live_nxt, ends <= nxt, True))
    return jnp.stack([starts, ends], axis=1), cs, ok


@functools.partial(jax.jit, static_argnames=("rounds",))
def _go_select_round(starts, ends, live, rounds: int):
    def step(sel):
        e = jnp.where(sel, ends, -1)
        prevmax = jnp.concatenate(
            [jnp.full(1, -1, jnp.int32), jax.lax.cummax(e)[:-1]])
        return live & (starts >= prevmax)

    sel = live
    for _ in range(rounds):
        sel = step(sel)
    stable = jnp.all(step(sel) == sel)
    return sel, stable


def go_select_device(starts, ends, cnt: int, cap: int,
                     max_rounds: int = 24):
    """Go's non-overlapping leftmost selection over verified candidate
    (start, end) pairs, on device.  The greedy walk's output is the
    UNIQUE fixed point of  sel[i] = (starts[i] >= max end of selected
    j < i)  (induction over i: the first candidate is always selected,
    and each later candidate's status is forced by its predecessors),
    so iterating that equation with a running masked cummax converges to
    the exact selection; convergence needs one round per level of the
    kill/revive alternation chain, which is bounded by overlap nesting
    depth (tiny in practice).  Returns (sel mask [cap] device, ok) — ok
    False when max_rounds didn't reach the fixed point (host fallback).

    Candidates must be start-sorted, non-empty spans (ends > starts),
    aligned; entries past cnt are ignored.  The host twin is
    meta/batch.py:go_select."""
    live = jnp.arange(cap, dtype=jnp.int32) < cnt
    sel, stable = _go_select_round(starts, ends, live, rounds=max_rounds)
    return sel, bool(jax.device_get(stable))


def go_select_flex_lazy(smin, smax, ends, cnt: int, cap: int,
                        max_rounds: int = 24):
    """go_select_flex without the host sync: returns (sel, stable_dev,
    starts, nsel_dev) so the caller can bundle the scalars into one
    device_get."""
    live = jnp.arange(cap, dtype=jnp.int32) < cnt
    sel, stable, starts = _go_select_flex_round(smin, smax, ends, live,
                                                rounds=max_rounds)
    return sel & live, stable, starts, (sel & live).sum(dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("lits",))
def multi_literal_span_masks(dev, lits: Tuple[Tuple[int, ...], ...]):
    """(startmask [n], endmask [n+1]) for an exact literal alternation,
    within-position priority resolved (first literal wins).  End bits
    are ORed shifted copies per distinct length, so no scatter; if any
    two hits overlap the pair fails spans_from_masks' validation and
    the caller falls back to the host selection walk."""
    n = dev.shape[0]
    best_len = jnp.zeros(n, dtype=jnp.int32)
    for lit in lits:  # first match at a position wins (priority)
        m = _memmem_mask(dev, lit)
        best_len = jnp.where((best_len == 0) & m, len(lit), best_len)
    smask = best_len > 0
    emask = jnp.zeros(n + 1, dtype=bool)
    for L in sorted({len(l) for l in lits}):
        hit = best_len == L
        emask = emask.at[L:].set(emask[L:] | hit[:n + 1 - L])
    return smask, emask


@functools.partial(jax.jit, static_argnames=("lit", "prefix",
                                             "line_anchored", "mode"))
def line_span_masks(dev, lit: Tuple[int, ...], prefix: Tuple[int, ...],
                    line_anchored: bool, mode: str):
    """(startmask [n+1], endmask [n+1]) for the line-shape family, one
    fused launch (the span twin of the fused line count kernel).

    mode: 'first_to_eol'  L.*          (first candidate, line end)
          'bol_to_last'   (?m)^P.*L    (line start, last candidate + k)
          'bol_to_eol'    (?m)^P.*L.*  (line start, line end)
    Candidate validity (lit fits before line end, line-anchored prefix
    gating) matches the count kernel exactly."""
    n = dev.shape[0]
    k = len(lit)
    cand = _memmem_mask(dev, lit)
    prev_nl, next_nl = line_bound_arrays(dev)
    idxs = jnp.arange(n, dtype=jnp.int32)
    valid = cand & (idxs + k <= next_nl)
    if line_anchored and len(prefix):
        prefix_at = _memmem_mask(dev, prefix)
        # previous byte via shift, NOT dev[idxs-1]: a shift is one
        # contiguous pass, a corpus-sized gather is not
        prev_byte = jnp.concatenate(
            [jnp.zeros(1, dtype=dev.dtype), dev[:-1]])
        is_ls = (idxs == 0) | (prev_byte == np.uint8(10))
        lg = jax.lax.cummax(jnp.where(is_ls & prefix_at, idxs, -1))
        line_good = lg == (prev_nl + 1)
        valid = valid & line_good & (idxs >= prev_nl + 1 + len(prefix))

    # last valid candidate index at or before p (running maxima)
    lv = jax.lax.cummax(jnp.where(valid, idxs, -1))
    lv_excl = jnp.concatenate([jnp.full(1, -1, jnp.int32), lv[:-1]])
    first_in_line = valid & (lv_excl <= prev_nl)
    # line terminator positions of lines holding a valid candidate:
    # at a newline (or EOT), the line had a candidate iff the last valid
    # index is past the line start
    nl_mask = dev == np.uint8(10)
    # at a newline q prev_nl[q] == q (inclusive <=); the line's own start
    # needs the strictly-previous newline
    prev_nl_excl = jnp.concatenate(
        [jnp.full(1, -1, jnp.int32), prev_nl[:-1]])
    line_has = lv > prev_nl_excl
    end_line_mask = jnp.concatenate(
        [nl_mask & line_has,
         # EOT terminates a line iff text doesn't end in \n
         jnp.full(1, (n > 0) & (dev[n - 1] != np.uint8(10))
                  & (lv[n - 1] > prev_nl[n - 1]), bool)])
    # last valid candidate of its line: next valid index lies past eol
    nv = jax.lax.cummin(
        jnp.where(valid, idxs, n)[::-1])[::-1]
    nv_excl = jnp.concatenate([nv[1:], jnp.full(1, n, jnp.int32)])
    last_in_line = valid & (nv_excl >= next_nl)
    # line starts of lines holding a valid candidate: the next valid
    # candidate index from here falls before this line's terminator
    is_ls_all = jnp.concatenate(
        [jnp.full(1, True), (dev == np.uint8(10))[:-1]])
    ls_has = is_ls_all & (nv < next_nl)
    pad1 = jnp.zeros(1, dtype=bool)
    if mode == "first_to_eol":
        smask = jnp.concatenate([first_in_line, pad1])
        emask = end_line_mask
    elif mode == "bol_to_last":
        smask = jnp.concatenate([ls_has, pad1])
        # end = last candidate + k (exclusive): shift the mask by k
        lm = jnp.concatenate([last_in_line, pad1])
        emask = jnp.zeros(n + 1, dtype=bool).at[k:].set(lm[:n + 1 - k])
    else:  # bol_to_eol
        smask = jnp.concatenate([ls_has, pad1])
        emask = end_line_mask
    return smask, emask


@functools.partial(jax.jit, static_argnames=("rounds",))
def _go_select_flex_round(smin, smax, ends, live, rounds: int):
    def prevmax(sel):
        e = jnp.where(sel, ends, -1)
        return jnp.concatenate(
            [jnp.full(1, -1, jnp.int32), jax.lax.cummax(e)[:-1]])

    def step(sel):
        return live & (prevmax(sel) <= smax)

    sel = live
    for _ in range(rounds):
        sel = step(sel)
    stable = jnp.all(step(sel) == sel)
    pm = prevmax(sel)
    starts = jnp.maximum(smin, pm)
    return sel, stable, starts


def go_select_flex(smin, smax, ends, cnt: int, cap: int,
                   max_rounds: int = 24):
    """Flexible-start Go selection: candidate i can start anywhere in
    [smin[i], smax[i]] (a class-run prefix admits every suffix of its
    run) with a FIXED end.  Go's walk picks, from restart position pos,
    the first candidate with smax >= pos, matching at max(smin, pos) —
    so selection is the unique fixed point of
    sel[i] = (max selected end among j < i) <= smax[i], and the emitted
    start is max(smin[i], that running max).  Returns
    (sel mask, ok, starts array) on device."""
    live = jnp.arange(cap, dtype=jnp.int32) < cnt
    sel, stable, starts = _go_select_flex_round(smin, smax, ends, live,
                                                rounds=max_rounds)
    return sel, bool(jax.device_get(stable)), starts
