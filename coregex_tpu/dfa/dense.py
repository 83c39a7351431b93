"""Dense DFA artifact — the central compiled object of the device build.

Where the reference determinizes lazily at search time into a flat
transition table (dfa/lazy/lazy.go:387-435 hot loop over
flatTrans[sid*stride+class]), we determinize *eagerly* at pattern-compile
time into dense numpy arrays that upload to the device once and are scanned by
data-parallel kernels:

  delta     [S, C] int32   next-state (state 0 == DEAD)
  match_on  [S, C] bool    "a match ends at the current position" given the
                           next byte's class — encodes the reference's
                           1-byte match delay (dfa/lazy/lazy.go:305-313)
                           and resolves \b / $ lookahead without branching
  match_eoi [S, 4] bool    match ends exactly at the scan-window edge, per
                           edge context {true EOI, word byte beyond, \n
                           beyond, other byte beyond} — lets bounded window
                           scans (reverse scans stopping at a restart
                           position, forward candidate windows) evaluate
                           $ / \b exactly at the edge
  starts    [4]    int32   start state per context {SOT, after-word,
                           after-\n, other} (dfa/lazy/start.go analogue)
  classes   [256]  int32   byte -> equivalence class
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# start context indices
CTX_SOT = 0
CTX_WORD = 1
CTX_NL = 2
CTX_OTHER = 3

DEAD = 0


@dataclass
class DenseDFA:
    delta: np.ndarray          # [S, C] int32
    match_on: np.ndarray       # [S, C] bool
    match_eoi: np.ndarray      # [S, 4] bool
    starts: np.ndarray         # [4] int32
    classes: np.ndarray        # [256] int32
    anchored: bool
    break_at_match: bool
    reverse: bool = False
    # metadata
    pattern: str = ""
    num_nfa_states: int = 0
    # empty-match classification (nullable count transducer support, only
    # populated by determinize_py(track_empty=True)): the flag that fires
    # at (s, c) / (s, eoi_ctx) is an EMPTY match at the current position
    # (its accepting thread is the fresh start spawned at this position)
    match_empty: Optional[np.ndarray] = None      # [S, C] bool
    match_eoi_empty: Optional[np.ndarray] = None  # [S, 4] bool

    @property
    def num_states(self) -> int:
        return self.delta.shape[0]

    @property
    def num_classes(self) -> int:
        return self.delta.shape[1]

    @staticmethod
    def context_of(prev_byte: Optional[int]) -> int:
        """Context index for a boundary whose adjacent outside byte is
        `prev_byte` (None == true start/end of text)."""
        from ..nfa.nfa import WORD_BYTES
        if prev_byte is None:
            return CTX_SOT
        if WORD_BYTES[prev_byte]:
            return CTX_WORD
        if prev_byte == 10:
            return CTX_NL
        return CTX_OTHER

    def start_for_context(self, prev_byte: Optional[int]) -> int:
        return int(self.starts[self.context_of(prev_byte)])

    # ------------------------------------------------------------------
    def scan_all_ends(self, data: np.ndarray,
                      start_state: Optional[int] = None,
                      sot: bool = True, eoi_ctx: int = CTX_SOT) -> np.ndarray:
        """Host (numpy) sequential scan: return bool mask of length n+1 where
        mask[p] == a match ends at offset p.  The scalar oracle for the device
        kernels (cf. SURVEY.md §4 implication (b)).  `eoi_ctx` describes what
        lies beyond the window's far edge (CTX_SOT == true end of text)."""
        n = len(data)
        cls = self.classes[data] if n else np.empty(0, dtype=np.int32)
        s = (start_state if start_state is not None
             else int(self.starts[CTX_SOT if sot else CTX_OTHER]))
        out = np.zeros(n + 1, dtype=bool)
        delta = self.delta
        match_on = self.match_on
        for p in range(n):
            c = cls[p]
            out[p] = match_on[s, c]
            s = delta[s, c]
            if s == DEAD:
                # DEAD is absorbing and matchless; stop early.
                return out
        out[n] = self.match_eoi[s, eoi_ctx]
        return out

    def earliest_match_end(self, data: np.ndarray) -> int:
        """First offset where a match ends, or -1 (host oracle)."""
        n = len(data)
        s = int(self.starts[CTX_SOT])
        delta, match_on = self.delta, self.match_on
        cls = self.classes
        for p in range(n):
            c = cls[data[p]]
            if match_on[s, c]:
                return p
            s = delta[s, c]
            if s == DEAD:
                return -1
        return n if self.match_eoi[s, CTX_SOT] else -1

    def nbytes(self) -> int:
        return (self.delta.nbytes + self.match_on.nbytes +
                self.match_eoi.nbytes + self.starts.nbytes +
                self.classes.nbytes)

    def minimized(self) -> "DenseDFA":
        """Moore minimization (partition refinement on the observable
        rows: match_on, match_eoi, and the empty-classification rows
        when present).  Exact — every input produces the same flag
        stream and EOI verdicts — and DEAD keeps id 0.  Shrinks the
        select trees of flag/reset scanners built on big automata
        (e.g. the anchored reverse DFA of `\\d+.\\d+.\\d+` drops 64 ->
        ~30 states)."""
        S, C = self.delta.shape
        sig0: dict = {}
        part = np.zeros(S, dtype=np.int64)
        for s in range(S):
            key = (tuple(self.match_on[s]), tuple(self.match_eoi[s]))
            if self.match_empty is not None:
                key = key + (tuple(self.match_empty[s]),
                             tuple(self.match_eoi_empty[s]))
            part[s] = sig0.setdefault(key, len(sig0))
        while True:
            sig: dict = {}
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
        # renumber so DEAD's block is 0 (kernels rely on DEAD == 0)
        remap = np.full(R, -1, dtype=np.int64)
        remap[part[DEAD]] = 0
        nxt = 1
        for s in range(S):
            b = part[s]
            if remap[b] < 0:
                remap[b] = nxt
                nxt += 1
        part = remap[part]
        rep = np.full(R, -1, dtype=np.int64)
        for s in range(S):
            if rep[part[s]] < 0:
                rep[part[s]] = s
        from dataclasses import replace
        return replace(
            self,
            delta=part[self.delta[rep]].astype(np.int32),
            match_on=self.match_on[rep].copy(),
            match_eoi=self.match_eoi[rep].copy(),
            starts=part[self.starts].astype(np.int32),
            classes=self.classes.copy(),
            match_empty=(None if self.match_empty is None
                         else self.match_empty[rep].copy()),
            match_eoi_empty=(None if self.match_eoi_empty is None
                             else self.match_eoi_empty[rep].copy()))
