"""Bitset-NFA device scan: the DFA-overflow fallback engine.

When eager determinization overflows (dfa/determinize.py state_limit),
the reference degrades to lazy determinization with cache clears and
finally its PikeVM (dfa/lazy/lazy.go:1472-1502, nfa/pikevm.go); this
repo's former fallback was the host PikeVM alone (~MB/s).  This module
keeps the corpus scan on the device for those patterns (SURVEY.md §7 build
item 5):

  * NFA RANGE states become lanes of a dense activity vector; a set of
    live Thompson threads is a 0/1 vector over the S range states plus a
    match flag.
  * One byte step is
        alive  = active ∧ (lo[s] <= b <= hi[s])          (compares)
        next   = (alive @ CT) > 0                        (matmul)
    where CT[s] is the epsilon-closure bitset of state s's target —
    the "precomputed move masks + or-reduce" of the survey expressed as
    a boolean mat-vec so the or-reduce runs as a matmul (sums of 0/1
    terms are exactly zero iff all terms are zero, so bf16/f32 rounding
    can never flip the >0 test).
  * Unanchored search seeds the anchored start closure at every
    position (the (?s:.)*? prefix unrolled into the step), so a flag at
    boundary p means "some match ends at p" — priority-free, which is
    why this engine discovers match ENDS/STARTS (sets), never
    leftmost-first ends (priority): those are resolved by the anchored
    verify DFA when it fits, else the host PikeVM, on the sparse
    candidate set (meta/batch.py:_bitset_* pipelines).
  * LOOK assertions (\\b, \\B, anchors) make the epsilon closure
    boundary-context-dependent.  The context of boundary p+1 is fully
    determined by (class of byte p, class of byte p+1) — word / newline
    / other / EOT — so the closure tables are built once per context,
    DEDUPED (a \\b-only pattern yields 2-4 distinct tables), and the
    step selects each lane's table by a precomputed context-group id:
    the same context-expansion the reference bakes into lazy-DFA state
    identity (/root/reference/dfa/lazy/state.go:130-176), applied to the
    activity vector's transition instead.  Patterns needing more than
    MAX_CTX_GROUPS distinct tables stay on the host.

Scope gate (checked at build): S <= MAX_BITSET_STATES, closure groups
<= MAX_CTX_GROUPS, and no empty match from the start closure in any
context.  Exactness at lane seams comes from the same entry/exit
fixpoint repair as the DFA chunk scan; `converged` is returned honestly
and callers fall back.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..nfa.nfa import NFA, Kind, Look, is_word_byte

MAX_BITSET_STATES = 512
MAX_CTX_GROUPS = 4

# boundary context classes (prev or next byte)
_C_OTHER, _C_WORD, _C_NL = 0, 1, 2
_N_EOT = 3  # next-class only


class LookUnsupported(Exception):
    """Out of bitset scope: too many states/context groups, or nullable."""


def _cls3(b: int) -> int:
    if is_word_byte(b):
        return _C_WORD
    return _C_NL if b == 10 else _C_OTHER


def _closure_ctx(nfa: NFA, sid: int, range_id: dict,
                 pw: bool, pnl: bool, at_start: bool,
                 nw: bool, nnl: bool, at_eoi: bool) -> Tuple[set, bool]:
    """Epsilon closure of `sid` under a full boundary context (mirrors
    determinize.closure_full's look evaluation exactly)."""
    seen = set()
    out: set = set()
    match = False
    stack = [sid]
    while stack:
        s = stack.pop()
        if s in seen:
            continue
        seen.add(s)
        st = nfa.states[s]
        k = st[0]
        if k == Kind.RANGE:
            out.add(range_id[s])
        elif k == Kind.MATCH:
            match = True
        elif k == Kind.SPLIT:
            stack.extend(st[1:])
        elif k == Kind.CAPTURE:
            stack.append(st[2])
        elif k == Kind.LOOK:
            look = st[1]
            ok = False
            if look == Look.BEGIN_TEXT:
                ok = at_start
            elif look == Look.BEGIN_LINE:
                ok = at_start or pnl
            elif look == Look.END_TEXT:
                ok = at_eoi
            elif look == Look.END_LINE:
                ok = at_eoi or nnl
            elif look == Look.WORD_BOUNDARY:
                ok = pw != nw
            elif look == Look.NO_WORD_BOUNDARY:
                ok = pw == nw
            if ok:
                stack.append(st[2])
        # FAIL: drop
    return out, match


def _ctx_args(pc: int, nc: int, at_start: bool = False):
    return dict(pw=pc == _C_WORD, pnl=pc == _C_NL, at_start=at_start,
                nw=nc == _C_WORD, nnl=nc == _C_NL, at_eoi=nc == _N_EOT)


class DeviceBitsetNFA:
    """Device tables for the bitset scan.

    lo/hi: [S] int32 per-range byte bounds.
    ct:    [G, S, S+1] — group g's closure table; row s = closure of
           state s's target under that boundary context, column S the
           match flag.  cmap[pc*4+nc] -> group id.
    start: [Gs, S] start-closure seeds per context group; smap[12].
    bot:   [4, S] start closures at text start (per next class).
    """

    def __init__(self, nfa: NFA):
        range_states = [i for i, st in enumerate(nfa.states)
                        if st[0] == Kind.RANGE]
        if len(range_states) > MAX_BITSET_STATES:
            raise LookUnsupported(
                f"{len(range_states)} range states > {MAX_BITSET_STATES}")
        rid = {s: j for j, s in enumerate(range_states)}
        S = len(range_states)
        self.S = S
        lo = np.zeros(S, dtype=np.int32)
        hi = np.zeros(S, dtype=np.int32)
        has_looks = nfa.any_look()
        ctxs = ([(pc, nc) for pc in range(3) for nc in range(4)]
                if has_looks else [(0, 0)])

        tables = {}
        cmap = np.zeros(12, dtype=np.int32)
        for (pc, nc) in ctxs:
            ct = np.zeros((S, S + 1), dtype=np.float32)
            for s, j in rid.items():
                st = nfa.states[s]
                lo[j], hi[j] = st[1], st[2]
                tgt, m = _closure_ctx(nfa, st[3], rid,
                                      **_ctx_args(pc, nc))
                for t in tgt:
                    ct[j, t] = 1.0
                if m:
                    ct[j, S] = 1.0
            key = ct.tobytes()
            if key not in tables:
                tables[key] = (len(tables), ct)
            gid = tables[key][0]
            if has_looks:
                cmap[pc * 4 + nc] = gid
        G = len(tables)
        if G > MAX_CTX_GROUPS:
            raise LookUnsupported(f"{G} closure context groups")
        ct_stack = np.stack(
            [t for _, t in sorted(tables.values())], axis=0)

        # start seeds per context + BOT variants; nullable in ANY
        # context is out of scope (empty matches end everywhere)
        starts = {}
        smap = np.zeros(12, dtype=np.int32)
        nullable = False
        for (pc, nc) in ctxs:
            sset, m = _closure_ctx(nfa, nfa.start_anchored, rid,
                                   **_ctx_args(pc, nc))
            nullable |= m
            v = np.zeros(S, dtype=np.float32)
            for t in sset:
                v[t] = 1.0
            key = v.tobytes()
            if key not in starts:
                starts[key] = (len(starts), v)
            if has_looks:
                smap[pc * 4 + nc] = starts[key][0]
        start_stack = np.stack(
            [v for _, v in sorted(starts.values())], axis=0)
        bot = np.zeros((4, S), dtype=np.float32)
        for nc in range(4 if has_looks else 1):
            sset, m = _closure_ctx(nfa, nfa.start_anchored, rid,
                                   **_ctx_args(0, nc, at_start=True))
            nullable |= m
            for t in sset:
                bot[nc, t] = 1.0
        if not has_looks:
            bot[:] = bot[0]
        self.nullable = bool(nullable)
        self.G = G
        self.Gs = len(starts)
        self.has_looks = has_looks
        # 0/1 operands with f32 accumulation: exact at any matmul
        # precision (TF32 or bf16 inputs round nothing here)
        dt = jnp.float32
        self.dtype = dt
        self.lo = jnp.asarray(lo)
        self.hi = jnp.asarray(hi)
        self.ct = jnp.asarray(ct_stack, dtype=dt)
        self.start = jnp.asarray(start_stack)
        self.bot = jnp.asarray(bot)
        self.cmap = jnp.asarray(cmap)
        self.smap = jnp.asarray(smap)


def plan_bitset_geometry(n: int, S: int) -> Tuple[int, int]:
    """(L, T): L lanes of T bytes.  Lane count balances the matmul batch
    shape (>=128 rows) against per-lane state memory L*S."""
    from .transducer import size_bucket
    nb = size_bucket(max(n, 1))
    L = 256
    while L > 8 and L * 64 > nb:
        L //= 2
    T = -(-nb // L)
    T = -(-T // 64) * 64
    return L, T


@functools.partial(
    jax.jit, static_argnames=("S", "L", "T", "G", "Gs", "max_repair"))
def _bitset_scan(lo, hi, ct, start_tbl, bot, cmap, smap, data_u8, n,
                 S: int, L: int, T: int, G: int, Gs: int,
                 max_repair: int = 4):
    """Full-corpus unanchored all-ends scan.  Returns (flags [L*T] bool —
    flag at global position p-1 set iff a match ends at boundary p —
    and converged bool)."""
    pad = L * T - data_u8.shape[0]
    chunks = jnp.pad(data_u8, (0, pad)).reshape(L, T)
    limits = jnp.clip(n - jnp.arange(L, dtype=jnp.int32) * T, 0, T)

    dt = ct.dtype

    # context id of boundary t+1 per (lane, t): prev = byte t, next =
    # byte t+1 (the next lane's first byte across the seam; EOT at n)
    def cls3(b):
        w = ((b >= 48) & (b <= 57)) | ((b >= 65) & (b <= 90)) \
            | (b == 95) | ((b >= 97) & (b <= 122))
        return jnp.where(w, _C_WORD,
                         jnp.where(b == 10, _C_NL, _C_OTHER))

    nxt_bytes = jnp.concatenate(
        [chunks[:, 1:],
         jnp.concatenate([chunks[1:, :1],
                          jnp.zeros((1, 1), chunks.dtype)])], axis=1)
    pos1 = (jnp.arange(L, dtype=jnp.int32)[:, None] * T
            + jnp.arange(T, dtype=jnp.int32)[None, :] + 1)
    nc = jnp.where(pos1 == n, _N_EOT, cls3(nxt_bytes.astype(jnp.int32)))
    pc = cls3(chunks.astype(jnp.int32))
    ctx = pc * 4 + nc                                    # [L, T]
    gids = cmap[ctx].astype(jnp.int8)                    # [L, T]
    sids = smap[ctx].astype(jnp.int8)

    def step(active, b, gid, sid, live):
        """active [L,S] bf16; b/gid/sid [L]; live [L] bool."""
        ok = ((b[:, None] >= lo[None, :])
              & (b[:, None] <= hi[None, :]))
        alive = jnp.where(ok, active, 0).astype(dt)
        nxt = jnp.zeros((active.shape[0], S + 1), dtype=jnp.float32)
        for g in range(G):
            contrib = jnp.dot(alive, ct[g],
                              preferred_element_type=jnp.float32)
            nxt = nxt + jnp.where((gid == g)[:, None], contrib, 0.0)
        flag = (nxt[:, S] > 0) & live
        nr = (nxt[:, :S] > 0).astype(dt)
        # unanchored restart: seed the start closure at every position
        seed = jnp.zeros((active.shape[0], S), dtype=dt)
        for gs in range(Gs):
            seed = seed + jnp.where((sid == gs)[:, None],
                                    start_tbl[gs].astype(dt), 0)
        nr = jnp.maximum(nr, seed)
        act2 = jnp.where(live[:, None], nr, active)
        return act2, flag

    def scan_once(entries):
        def body(carry, xc):
            active = carry
            t, b, gid, sid = xc
            live = t < limits
            act2, flag = step(active, b, gid, sid, live)
            return act2, flag

        xs = (jnp.arange(T, dtype=jnp.int32), chunks.T, gids.T, sids.T)
        exits, flags = jax.lax.scan(body, entries, xs)
        return flags, exits                      # flags [T, L]

    # lane entries: start closure at the lane's first boundary — BOT for
    # lane 0, else the context of (preceding byte, first byte)
    first_b = chunks[:, 0].astype(jnp.int32)
    prev_b = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), chunks[:-1, T - 1].astype(jnp.int32)])
    ctx0 = cls3(prev_b) * 4 + cls3(first_b)
    seed0 = start_tbl[smap[ctx0]]                        # [L, S]
    bot0 = bot[cls3(first_b[0])]
    entries0 = jnp.concatenate(
        [bot0[None, :], seed0[1:]], axis=0).astype(dt)

    flags0, exits0 = scan_once(entries0)

    lane_ids = jnp.arange(L, dtype=jnp.int32)
    real = (lane_ids * T) < n

    def want_of(exits):
        prev = jnp.concatenate([entries0[:1], exits[:-1]])
        return prev

    def differs(entries, exits):
        w = want_of(exits)
        return jnp.any(real[:, None] & (w != entries))

    def cond(stv):
        k, entries, flags, exits = stv
        return (k < max_repair) & differs(entries, exits)

    def rep(stv):
        k, entries, flags, exits = stv
        ne = want_of(exits)
        f2, e2 = scan_once(ne)
        return (k + 1, ne, f2, e2)

    k, entries, flags, exits = jax.lax.while_loop(
        cond, rep, (jnp.int32(0), entries0, flags0, exits0))
    converged = ~differs(entries, exits)
    return flags.T.reshape(L * T), converged


class BitsetNFAScanner:
    """Unanchored all-ends scan for one byte-NFA (forward or reverse).

    ends(dev, n) -> (sorted unique end boundaries np.int64, ok bool):
    boundary p in 1..n is reported iff some match ends exactly at p."""

    def __init__(self, nfa: NFA):
        self.d = DeviceBitsetNFA(nfa)
        if self.d.nullable:
            # empty matches end everywhere; the candidate set degenerates
            raise LookUnsupported("nullable pattern")

    def flags(self, dev: jnp.ndarray):
        n = int(dev.shape[0])
        L, T = plan_bitset_geometry(n, self.d.S)
        d = self.d
        flags, conv = _bitset_scan(
            d.lo, d.hi, d.ct, d.start, d.bot, d.cmap, d.smap, dev,
            jnp.int32(n), S=d.S, L=L, T=T, G=d.G, Gs=d.Gs)
        return flags, conv

    def ends(self, dev: jnp.ndarray) -> Tuple[Optional[np.ndarray], bool]:
        from .bytescan import mask_positions
        n = int(dev.shape[0])
        if n == 0:
            return np.empty(0, dtype=np.int64), True
        flags, conv = self.flags(dev)
        if not bool(jax.device_get(conv)):
            return None, False
        pos = mask_positions(flags[:n])
        return pos + 1, True
