"""Count transducer: Go's FindAll restart loop compiled into ONE weighted DFA.

The reference counts matches by repeatedly running its leftmost-first search
and restarting at each match end (meta/findall.go:297-376 Count over the
same loop as FindAllIndicesStreaming).  That loop is branchy and sequential;
on the device we instead observe that the *entire* restart process is itself a
deterministic finite-state transduction of the input:

  product state = a chain of "search frames", each a state of the
  unanchored leftmost-first DFA U (break-at-match determinization):
    frame 0     — the active search whose flags decide match ends;
    frames 1..k — searches restarted at earlier frames' latest flags
                  (every frame except the last has flagged; the last is the
                  pre-flag spawn search, which can never die).

  On each byte: the first flagging frame truncates the chain behind it and
  spawns a fresh restart frame; all frames step; dead frames at the front
  commit one match each and shift off.  At end of input every flagged frame
  commits (match_eoi may extend the foremost flag to n first).

Eagerly determinizing this process yields a dense table
  delta[S,C], emit[S,C]  (matches committed on the transition),
  eoi_commits[S,4]       (matches committed at a window edge, per context)
so `Count` becomes a single data-parallel scan summing `emit` — the same
kernel shape as the plain DFA scan, with exact Go span semantics baked in.

Frame chains can explode for pathological patterns (`a.*b|a` grows a frame
per input byte); construction caps chain length and state count and returns
None, and the engine falls back to the two-pass span pipeline.

Reference semantics mirrored: leftmost-first ends = last flag before death
(dfa/lazy/lazy.go search loops + break-at-match builder.go:172-239);
restart-at-match-end non-overlap rule (regex.go allMatches).  Only valid
for non-nullable patterns (no empty matches) in leftmost-first mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..nfa.nfa import WORD_BYTES
from .dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD, DEAD, DenseDFA

DEFAULT_CHAIN_LIMIT = 12
DEFAULT_STATE_LIMIT = 4096
EMIT_LIMIT = 31  # emit packs into 5 bits next to delta in device tables
SPAN_EMIT_LIMIT = 7  # span tables pack commits in 3 bits next to 2 flag bits

# diagnostic hook: set to a list to record why spans_simple was cleared
_SPAN_TRACE = None

# eoi_kind values (span-event reconstruction at end of input)
EOI_NONE = 0      # no EOI match: every group's end = its last flag
EOI_EXTEND = 1    # last flagged frame matches at EOI: last group end -> n
EOI_EXTRA = 2     # the fresh frame matches at EOI: append one end-n match
EOI_COMPLEX = 3   # EOI walk drops a flagged frame: events polluted


@dataclass
class CountDFA:
    delta: np.ndarray        # [S, C] int32
    emit: np.ndarray         # [S, C] int16  (commits on the transition)
    eoi_commits: np.ndarray  # [S, 4] int16  (commits at edge, per context)
    starts: np.ndarray       # [4] int32
    classes: np.ndarray      # [256] int32
    pattern: str = ""
    max_chain: int = 1
    # span-event tables (round 5, build_count_dfa only): flag_on marks
    # transitions where the first-flagging frame flagged (a candidate
    # match END at the current position); first_on marks the subset that
    # are the flagging frame's FIRST flag (group boundaries).  Valid for
    # event-stream span reconstruction only when spans_simple — no
    # reachable transition ever truncates an already-flagged frame, so
    # flags partition into consecutive per-match groups and each match's
    # end is its group's last flag (the EOI tail resolves via eoi_kind
    # at the scan's final state).  See ops/span_scan.py.
    flag_on: Optional[np.ndarray] = None   # [S, C] bool
    first_on: Optional[np.ndarray] = None  # [S, C] bool
    eoi_kind: Optional[np.ndarray] = None  # [S, 4] int8
    spans_simple: bool = False
    # nullable transducers advance one BYTE after an empty match; Go
    # advances one RUNE (utf8.DecodeRune width).  The two agree unless an
    # empty-match advance lands on a byte that starts a valid multi-byte
    # sequence — callers must gate on the corpus containing no bytes in
    # [0xC2, 0xF4] (every other byte decodes with width 1).
    requires_width1: bool = False

    @property
    def num_states(self) -> int:
        return self.delta.shape[0]

    @property
    def num_classes(self) -> int:
        return self.delta.shape[1]

    def count_scan(self, data: np.ndarray, eoi_ctx: int = CTX_SOT) -> int:
        """Host oracle: sequential scan accumulating emissions."""
        s = int(self.starts[CTX_SOT])
        total = 0
        delta, emit = self.delta, self.emit
        for c in self.classes[np.asarray(data, dtype=np.uint8)]:
            total += int(emit[s, c])
            s = delta[s, c]
        return total + int(self.eoi_commits[s, eoi_ctx])

    def nbytes(self) -> int:
        return (self.delta.nbytes + self.emit.nbytes +
                self.eoi_commits.nbytes + self.starts.nbytes +
                self.classes.nbytes)

    def without_spans(self) -> "CountDFA":
        """Copy with the span-event tables dropped, so `minimized()`
        merges on count behavior alone (the count select tree stays
        maximally minimized: span-observable rows split 1-4 extra
        states on the bench patterns)."""
        from dataclasses import replace
        return replace(self, flag_on=None, first_on=None,
                       eoi_kind=None, spans_simple=False)

    def span_ends_scan(self, data) -> Optional[List[int]]:
        """Host oracle: match ENDS reconstructed from the span-event
        stream (spans_simple only).  Flags partition into consecutive
        groups delimited by first-flags; each group's end is its last
        flag; eoi_kind at the final state resolves the tail.  This is
        the sequential twin of the device reconstruction in
        ops/span_scan.py — tests pin both against re.finditer."""
        if not self.spans_simple or self.flag_on is None:
            return None
        s = int(self.starts[CTX_SOT])
        ends: List[int] = []
        cur = -1  # current group's last flag (-1: no open group)
        delta, flag, first = self.delta, self.flag_on, self.first_on
        for p, c in enumerate(self.classes[np.asarray(data,
                                                     dtype=np.uint8)]):
            if flag[s, c]:
                if first[s, c] and cur >= 0:
                    ends.append(cur)
                cur = p
            s = int(delta[s, c])
        if cur >= 0:
            ends.append(cur)
        kind = int(self.eoi_kind[s, CTX_SOT])
        if kind == EOI_COMPLEX:
            return None
        if kind == EOI_EXTEND:
            ends[-1] = len(data)
        elif kind == EOI_EXTRA:
            ends.append(len(data))
        return ends

    def minimized(self) -> "CountDFA":
        """Mealy-machine minimization (Moore partition refinement):
        states with identical observable behavior — emit row, EOI row,
        and transitions into equal behavior classes — merge.  Exact:
        every input sequence produces the same emission stream and EOI
        commit.  Shrinks the device select trees beyond the syntactic
        row/column dedup (ops/count_scan.py) because equivalent-but-not-
        identical rows collapse too."""
        S, C = self.delta.shape
        # initial partition: (emit row, eoi row) — plus the span-event
        # rows when present (states with different flag/first/eoi-kind
        # behavior must NOT merge: the event stream is observable)
        sig0 = {}
        part = np.zeros(S, dtype=np.int64)
        for s in range(S):
            key = (tuple(self.emit[s]), tuple(self.eoi_commits[s]))
            if self.flag_on is not None:
                key = key + (tuple(self.flag_on[s]),
                             tuple(self.first_on[s]),
                             tuple(self.eoi_kind[s]))
            part[s] = sig0.setdefault(key, len(sig0))
        while True:
            sig = {}
            new = np.zeros(S, dtype=np.int64)
            for s in range(S):
                key = (part[s],) + tuple(part[self.delta[s]])
                new[s] = sig.setdefault(key, len(sig))
            if len(sig) == len(set(part.tolist())):
                part = new
                break
            part = new
        R = len(set(part.tolist()))
        if R == S:
            return self
        # canonical representative per block (first occurrence)
        rep = np.full(R, -1, dtype=np.int64)
        for s in range(S):
            if rep[part[s]] < 0:
                rep[part[s]] = s
        delta = part[self.delta[rep]].astype(np.int32)
        emit = self.emit[rep].copy()
        eoi = self.eoi_commits[rep].copy()
        starts = part[self.starts].astype(np.int32)
        return CountDFA(delta=delta, emit=emit, eoi_commits=eoi,
                        starts=starts, classes=self.classes.copy(),
                        pattern=self.pattern, max_chain=self.max_chain,
                        requires_width1=self.requires_width1,
                        flag_on=(None if self.flag_on is None
                                 else self.flag_on[rep].copy()),
                        first_on=(None if self.first_on is None
                                  else self.first_on[rep].copy()),
                        eoi_kind=(None if self.eoi_kind is None
                                  else self.eoi_kind[rep].copy()),
                        spans_simple=self.spans_simple)


# Frames are run-length compressed: ((u_state, multiplicity), ...).  Equal
# adjacent frames evolve identically forever, so a run commits
# `multiplicity` matches when it dies at the front of the chain.
_Frames = Tuple[Tuple[int, int], ...]
_Key = Tuple[_Frames, int]


def build_count_dfa_nullable(u: DenseDFA,
                             chain_limit: int = DEFAULT_CHAIN_LIMIT,
                             state_limit: int = DEFAULT_STATE_LIMIT
                             ) -> Optional[CountDFA]:
    """Count transducer for NULLABLE patterns: Go's FindAll loop with its
    empty-match rules (regex.go allMatches) compiled into one weighted DFA.

    `u` must come from determinize_py(track_empty=True) (unanchored,
    break-at-match): match_empty classifies each flag as an empty match at
    the current position (fresh-thread accept) vs non-empty.

    Frames carry a FLAGGED bit (has this search recorded a match
    candidate?); a frame that dies unflagged commits nothing — it was a
    speculative search whose leftmost match turned out to be a rejected
    empty.  Rules on top of build_count_dfa's chain:

      * empty flag at p (match_empty classification): the candidate match
        is [p,p]; if it stands (frame dies without re-flagging), Go
        advances pos to p+width, so the restart spawns POST-step as a
        fresh start state ("START-NEXT", first checked at p+1; width-1
        gated via requires_width1).

      * non-empty flag at e: the restart searches from e.  Its leftmost
        match may be the empty match AT e — which Go REJECTS
        (start == prevMatchEnd, regex.go allMatches) and re-searches
        from e+1, abandoning even viable lower-priority non-empty
        matches at e.  Whether the empty stands is only known when the
        restart's higher-priority threads die, so BOTH contingencies
        spawn: the pre-step frame delta[start,c] (the threads above the
        empty accept — non-empty attempts at e; unflagged, commits
        nothing if it dies) and, when the empty candidate exists
        (match_u[start,c] — at a start state any accept is the fresh
        empty), a START-NEXT frame for the rejected case.  A later flag
        of any earlier frame truncates both (speculation invalidated).

      * EOI: walk frames in order; flagged frames commit; the first
        frame whose state matches at EOI also commits and ends the walk
        (the next search would start at n and its empty is rejected).
    """
    if u.anchored or not u.break_at_match or u.match_empty is None:
        raise ValueError("nullable count DFA requires the unanchored "
                         "break-at-match empty-tracking forward DFA")
    C = u.num_classes
    delta_u = u.delta
    match_u = u.match_on
    empty_u = u.match_empty
    eoi_u = u.match_eoi
    starts_u = u.starts

    rep = [0] * C
    for b in range(255, -1, -1):
        rep[int(u.classes[b])] = b
    ctx_of_cls = [
        CTX_WORD if WORD_BYTES[rb] else (CTX_NL if rb == 10 else CTX_OTHER)
        for rb in rep
    ]
    needs_ctx = not (int(starts_u[0]) == int(starts_u[1])
                     == int(starts_u[2]) == int(starts_u[3]))

    # frame = ((u_state, flagged), multiplicity)
    key_to_id = {}
    keys: List[tuple] = []
    dead_key = ((), 0)
    key_to_id[dead_key] = DEAD
    keys.append(dead_key)

    def intern(k) -> Optional[int]:
        i = key_to_id.get(k)
        if i is None:
            i = len(keys)
            if i > state_limit:
                return None
            key_to_id[k] = i
            keys.append(k)
        return i

    starts = np.zeros(4, dtype=np.int32)
    for ctx in range(4):
        k = ((((int(starts_u[ctx]), False), 1),), ctx if needs_ctx else 0)
        sid = intern(k)
        if sid is None:
            return None
        starts[ctx] = sid

    rows_d: List[np.ndarray] = []
    rows_e: List[np.ndarray] = []
    rows_eoi: List[np.ndarray] = []
    max_chain = 1
    i = 0
    while i < len(keys):
        frames, pctx = keys[i]
        drow = np.zeros(C, dtype=np.int32)
        erow = np.zeros(C, dtype=np.int16)
        eoirow = np.zeros(4, dtype=np.int16)
        if frames:
            total_mult = sum(m for _, m in frames)
            max_chain = max(max_chain, total_mult)
            start_here = int(starts_u[pctx if needs_ctx else CTX_SOT])
            for c in range(C):
                # 1. first flagging frame truncates the chain behind it
                #    and spawns its restart contingencies
                out: List[Tuple[Tuple[int, bool], int]] = []
                flagged = False
                flag_empty = False
                for ((s, fl), m) in frames:
                    if match_u[s, c]:
                        out.append(((s, True), 1))
                        flagged = True
                        flag_empty = bool(empty_u[s, c])
                        break
                    out.append(((s, fl), m))
                post_spawn = False
                if flagged:
                    if flag_empty:
                        # candidate [p,p]: restart searches from p+1
                        post_spawn = True
                    else:
                        # restart searches from e: non-empty attempts at
                        # e step in pre-step; the rejected-empty
                        # contingency (if an empty candidate exists at
                        # e) respawns from e+1
                        out.append(((start_here, False), 1))
                        if match_u[start_here, c]:
                            post_spawn = True
                # 2. step every frame
                merged: List[Tuple[Tuple[int, bool], int]] = []

                def put(sf, m):
                    if merged and merged[-1][0] == sf:
                        merged[-1] = (sf, merged[-1][1] + m)
                    else:
                        merged.append((sf, m))

                for ((s, fl), m) in out:
                    put((int(delta_u[s, c]), fl), m)
                if post_spawn:
                    ns = int(starts_u[ctx_of_cls[c] if needs_ctx
                                      else CTX_SOT])
                    put((ns, False), 1)
                # 3. dead-frame resolution.  Unflagged dead frames drop
                #    anywhere (pure speculation, commit nothing).
                #    Flagged dead frames commit only once they reach the
                #    FRONT — an earlier live frame may still re-flag and
                #    truncate them (their candidate match would be
                #    superseded), so mid-chain they stay as pending
                #    commits.
                kept = [fm for fm in merged
                        if not (fm[0][0] == DEAD and not fm[0][1])]
                merged = []
                for sf, m in kept:
                    put(sf, m)
                commits = 0
                while merged and merged[0][0] == (DEAD, True):
                    commits += merged[0][1]
                    merged.pop(0)
                if commits > EMIT_LIMIT:
                    return None
                if sum(m for _, m in merged) > chain_limit:
                    return None
                if not merged:
                    nk = dead_key
                else:
                    nk = (tuple(merged),
                          ctx_of_cls[c] if needs_ctx else 0)
                nid = intern(nk)
                if nid is None:
                    return None
                drow[c] = nid
                erow[c] = commits
            for ctx in range(4):
                # flagged frames commit; the first EOI-matching frame
                # commits and ends the walk (the restart from n would
                # only find the rejected empty at n)
                commits = 0
                for ((s, fl), m) in frames:
                    if eoi_u[s, ctx]:
                        commits += 1
                        break
                    if fl:
                        commits += m
                eoirow[ctx] = commits
        rows_d.append(drow)
        rows_e.append(erow)
        rows_eoi.append(eoirow)
        i += 1

    return CountDFA(
        delta=np.stack(rows_d),
        emit=np.stack(rows_e),
        eoi_commits=np.stack(rows_eoi),
        starts=starts,
        classes=u.classes.astype(np.int32),
        pattern=u.pattern,
        max_chain=max_chain,
        requires_width1=True,
    )


def build_count_dfa(u: DenseDFA,
                    chain_limit: int = DEFAULT_CHAIN_LIMIT,
                    state_limit: int = DEFAULT_STATE_LIMIT
                    ) -> Optional[CountDFA]:
    """Build the count transducer from the unanchored leftmost-first DFA.

    `u` must be unanchored with break_at_match=True and the pattern must be
    non-nullable (the caller guarantees both).  Returns None when the frame
    chain or product state count exceeds its limit.
    """
    if u.anchored or not u.break_at_match:
        raise ValueError("count DFA requires the unanchored "
                         "break-at-match forward DFA")
    C = u.num_classes
    delta_u = u.delta
    match_u = u.match_on
    eoi_u = u.match_eoi
    starts_u = u.starts

    # class -> context of a byte of that class (for restart start states)
    rep = [0] * C
    for b in range(255, -1, -1):
        rep[int(u.classes[b])] = b
    ctx_of_cls = [
        CTX_WORD if WORD_BYTES[rb] else (CTX_NL if rb == 10 else CTX_OTHER)
        for rb in rep
    ]
    needs_ctx = not (int(starts_u[0]) == int(starts_u[1])
                     == int(starts_u[2]) == int(starts_u[3]))

    key_to_id = {}
    keys: List[_Key] = []
    dead_key: _Key = ((), 0)
    key_to_id[dead_key] = DEAD
    keys.append(dead_key)

    def intern(k: _Key) -> Optional[int]:
        i = key_to_id.get(k)
        if i is None:
            i = len(keys)
            if i > state_limit:
                return None
            key_to_id[k] = i
            keys.append(k)
        return i

    starts = np.zeros(4, dtype=np.int32)
    for ctx in range(4):
        k: _Key = (((int(starts_u[ctx]), 1),), ctx if needs_ctx else 0)
        sid = intern(k)
        if sid is None:
            return None
        starts[ctx] = sid

    rows_d: List[np.ndarray] = []
    rows_e: List[np.ndarray] = []
    rows_eoi: List[np.ndarray] = []
    rows_flag: List[np.ndarray] = []
    rows_first: List[np.ndarray] = []
    rows_kind: List[np.ndarray] = []
    spans_simple = True
    max_chain = 1
    i = 0
    while i < len(keys):
        frames, pctx = keys[i]
        drow = np.zeros(C, dtype=np.int32)
        erow = np.zeros(C, dtype=np.int16)
        eoirow = np.zeros(4, dtype=np.int16)
        flagrow = np.zeros(C, dtype=bool)
        firstrow = np.zeros(C, dtype=bool)
        kindrow = np.zeros(4, dtype=np.int8)
        if frames:
            total_mult = sum(m for _, m in frames)
            K = total_mult
            max_chain = max(max_chain, total_mult)
            for c in range(C):
                # 1. first flagging (expanded) frame truncates + respawns.
                #    Span events (round 5): the expanded frame invariant is
                #    "frames 0..K-2 flagged, frame K-1 the fresh unflagged
                #    search" (spawns only happen at flags), so a flag by
                #    frame j < K-2 truncates an already-FLAGGED frame —
                #    its recorded flags would pollute the event stream —
                #    and the table is marked not spans_simple.  j == K-1
                #    is the fresh frame's FIRST flag (group boundary);
                #    j == K-2 is a greedy re-flag of the current group.
                out: List[Tuple[int, int]] = []
                flagged = False
                j_exp = 0
                for (s, m) in frames:
                    if match_u[s, c]:
                        out.append((s, 1))
                        flagged = True
                        break
                    out.append((s, m))
                    j_exp += m
                if flagged:
                    out.append((int(starts_u[pctx if needs_ctx
                                             else CTX_SOT]), 1))
                    flagrow[c] = True
                    firstrow[c] = j_exp == K - 1
                    if j_exp < K - 2:
                        if _SPAN_TRACE is not None:
                            _SPAN_TRACE.append(("flag-trunc", frames, c,
                                                j_exp, K))
                        spans_simple = False
                # 2. step every frame
                merged: List[Tuple[int, int]] = []
                for (s, m) in out:
                    ns = int(delta_u[s, c])
                    if merged and merged[-1][0] == ns:
                        merged[-1] = (ns, merged[-1][1] + m)
                    else:
                        merged.append((ns, m))
                # 3. dead frames at the front commit and shift off
                commits = 0
                while merged and merged[0][0] == DEAD:
                    s, m = merged[0]
                    if len(merged) == 1:
                        # all frames dead (the rune-based unanchored hunt
                        # dies on malformed UTF-8): flagged copies commit,
                        # the chain goes dead and stays matchless.  Span
                        # events remain consistent — committed groups
                        # closed by their last flags, no frame survives
                        # to re-flag — so spans_simple is unaffected.
                        commits += m - 1
                        merged = []
                        break
                    commits += m
                    merged.pop(0)
                if commits > EMIT_LIMIT:
                    return None
                if commits > SPAN_EMIT_LIMIT:
                    spans_simple = False
                if sum(m for _, m in merged) > chain_limit:
                    return None
                if not merged:
                    nk = dead_key
                else:
                    nk = (tuple(merged),
                          ctx_of_cls[c] if needs_ctx else 0)
                nid = intern(nk)
                if nid is None:
                    return None
                drow[c] = nid
                erow[c] = commits
            for ctx in range(4):
                # first EOI-flagging frame truncates; every flagged frame
                # (all but the last) commits
                commits = None
                pos = 0
                for (s, m) in frames:
                    if eoi_u[s, ctx]:
                        commits = pos + 1
                        break
                    pos += m
                eoirow[ctx] = (commits if commits is not None
                               else total_mult - 1)
                # span-event EOI kind (see module constants)
                if commits is None:
                    kindrow[ctx] = EOI_NONE
                elif pos == K - 1:
                    kindrow[ctx] = EOI_EXTRA
                elif pos == K - 2:
                    kindrow[ctx] = EOI_EXTEND
                else:
                    kindrow[ctx] = EOI_COMPLEX
        rows_d.append(drow)
        rows_e.append(erow)
        rows_eoi.append(eoirow)
        rows_flag.append(flagrow)
        rows_first.append(firstrow)
        rows_kind.append(kindrow)
        i += 1

    return CountDFA(
        delta=np.stack(rows_d),
        emit=np.stack(rows_e),
        eoi_commits=np.stack(rows_eoi),
        starts=starts,
        classes=u.classes.astype(np.int32),
        pattern=u.pattern,
        max_chain=max_chain,
        flag_on=np.stack(rows_flag),
        first_on=np.stack(rows_first),
        eoi_kind=np.stack(rows_kind),
        spans_simple=spans_simple,
    )
