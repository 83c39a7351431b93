"""AST -> byte-level Thompson NFA.

Capability analogue of the reference's NFA compiler (nfa/compile.go:99
CompileRegexp): UTF-8 rune lowering, priority-ordered splits encoding
leftmost-first preference, the non-greedy `(?s:.)*?` unanchored prefix
(nfa/compile.go:1633 analogue), capture slots, and a UTF-8 suffix cache
(nfa/utf8_suffix.go analogue) for compact class compilation.

`reverse=True` compiles the *reversed* language (for reverse DFAs that find
match starts): concatenations flip, rune byte sequences flip, and
begin/end assertions swap — equivalent to the reference's edge-reversal
(nfa/reverse.go) but done at the AST level.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..syntax.ast import Node, Op
from ..syntax.parser import Parsed
from .nfa import NFA, Kind, Look
from .utf8 import class_to_byte_seqs

MAX_STATES = 200_000

# patch hole: (state_id, index into state list)
Hole = Tuple[int, int]


class CompileError(ValueError):
    pass


def ast_nullable(n: Node) -> bool:
    """Whether the sub-expression can match the empty string
    (canMatchEmpty, reference nfa/compile.go:1389)."""
    op = n.op
    if op in (Op.EMPTY, Op.STAR, Op.QUEST):
        return True
    if op in (Op.BEGIN_LINE, Op.END_LINE, Op.BEGIN_TEXT,
              Op.END_TEXT, Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY):
        return True
    if op == Op.LITERAL:
        return len(n.runes) == 0
    if op == Op.PLUS or op == Op.CAPTURE:
        return ast_nullable(n.subs[0])
    if op == Op.REPEAT:
        return n.min == 0 or ast_nullable(n.subs[0])
    if op == Op.CONCAT:
        return all(ast_nullable(s) for s in n.subs)
    if op == Op.ALTERNATE:
        return any(ast_nullable(s) for s in n.subs)
    return False


class Frag:
    __slots__ = ("start", "outs", "nullable")

    def __init__(self, start: int, outs: List[Hole]):
        self.start = start
        self.outs = outs


class Compiler:
    def __init__(self, reverse: bool = False, with_captures: bool = True,
                 ascii_only: bool = False):
        """ascii_only: project every class/literal to its ASCII subset —
        the reference's dot-optimized ASCII NFA (meta/compile.go:386-430
        buildDotOptimizedNFAs), valid for corpora where simd.IsASCII
        holds: bytes >= 0x80 never occur, so rune branches above ASCII
        are unreachable and `.` collapses to a single byte range.  Byte
        classes shrink from ~15-25 (UTF-8 boundaries) to ~3-6, which is
        what keeps the dense count/scan tables small."""
        self.reverse = reverse
        self.with_captures = with_captures and not reverse
        self.ascii_only = ascii_only
        self.nfa = NFA()
        self._suffix_cache = {}

    # ------------------------------------------------------------------
    def compile(self, parsed: Parsed) -> NFA:
        nfa = self.nfa
        nfa.pattern = parsed.pattern
        nfa.group_names = list(parsed.group_names)
        nfa.num_slots = 2 * (parsed.num_captures + 1)

        body = self._compile(parsed.ast)

        match_id = nfa.add_match()
        if self.with_captures:
            cap_end = nfa.add_capture(1, match_id)
            tail = cap_end
        else:
            tail = match_id
        for hole in body.outs:
            nfa.patch(*hole, tail)

        if self.with_captures:
            anchored = nfa.add_capture(0, body.start)
        else:
            anchored = body.start
        nfa.start_anchored = anchored

        # unanchored (?s:.)*? prefix: prefer entering the pattern
        # (leftmost).  Go's unanchored search only probes rune boundaries
        # as match starts (reference nfa/compile.go:1633 compiles a rune
        # prefix), so when a match could begin mid-sequence — the pattern
        # is nullable (empty-width matches anywhere) or a class carries
        # the invalid-byte branch (first byte 0x80+) — the loop must step
        # RUNES (valid UTF-8 sequence, or one invalid byte).  Otherwise
        # every match start byte is ASCII or a valid lead byte, byte- and
        # rune-stepping probe the same match set, and the single-state
        # byte loop keeps byte classes compact (<= 4 for ASCII patterns)
        # for the dense kernels.
        loop = nfa.add_split([anchored, -1])
        # ASCII projection: rune == byte, so byte stepping is exact
        if not self.ascii_only and self._needs_rune_prefix(parsed.ast):
            any_rune = self._compile_class(((0, 0x10FFFF),))
            for h in any_rune.outs:
                nfa.patch(*h, loop)
            nfa.patch(loop, 2, any_rune.start)
        else:
            any_byte = nfa.add_range(0, 255, loop)
            nfa.patch(loop, 2, any_byte)
        nfa.start_unanchored = loop
        return nfa

    @staticmethod
    def _needs_rune_prefix(ast: Node) -> bool:
        """True when a match could start mid-rune under byte stepping:
        the pattern can match empty, or some class matches invalid bytes
        (contains U+FFFD, so its NFA grows the 0x80+ single-byte
        branch)."""

        nullable = ast_nullable

        def has_fffd(n: Node) -> bool:
            if n.op in (Op.ANY_CHAR, Op.ANY_NOT_NL):
                return True
            if n.op == Op.CHAR_CLASS:
                return any(lo <= 0xFFFD <= hi for lo, hi in n.ranges)
            return any(has_fffd(s) for s in (n.subs or ()))

        return nullable(ast) or has_fffd(ast)

    # ------------------------------------------------------------------
    def _check_size(self):
        if len(self.nfa) > MAX_STATES:
            raise CompileError("expression too large")

    def _compile(self, node: Node) -> Frag:
        self._check_size()
        op = node.op
        if op == Op.EMPTY:
            sid = self.nfa.add_split([-1])
            return Frag(sid, [(sid, 1)])
        if op == Op.NO_MATCH:
            sid = self.nfa.add_fail()
            return Frag(sid, [])
        if op == Op.LITERAL:
            return self._compile_literal(node.runes)
        if op == Op.CHAR_CLASS:
            return self._compile_class(node.ranges)
        if op == Op.ANY_CHAR:
            return self._compile_class(((0, 0x10FFFF),))
        if op == Op.ANY_NOT_NL:
            return self._compile_class(((0, 9), (11, 0x10FFFF)))
        if op in (Op.BEGIN_LINE, Op.END_LINE, Op.BEGIN_TEXT, Op.END_TEXT,
                  Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY):
            return self._compile_look(op)
        if op == Op.CAPTURE:
            return self._compile_capture(node)
        if op == Op.CONCAT:
            subs = node.subs[::-1] if self.reverse else node.subs
            return self._compile_concat(subs)
        if op == Op.ALTERNATE:
            return self._compile_alternate(node.subs)
        if op == Op.STAR:
            return self._compile_star(node.subs[0], node.greedy)
        if op == Op.PLUS:
            return self._compile_plus(node.subs[0], node.greedy)
        if op == Op.QUEST:
            return self._compile_quest(node.subs[0], node.greedy)
        if op == Op.REPEAT:
            return self._compile_repeat(node)
        raise CompileError(f"unsupported op {op}")

    def _compile_literal(self, runes) -> Frag:
        if not runes:
            sid = self.nfa.add_split([-1])
            return Frag(sid, [(sid, 1)])
        if self.ascii_only and any(cp >= 0x80 for cp in runes):
            sid = self.nfa.add_fail()  # unreachable in an ASCII corpus
            return Frag(sid, [])
        seq = runes[::-1] if self.reverse else runes
        start = -1
        prev_holes: List[Hole] = []
        for cp in seq:
            enc = chr(cp).encode("utf-8")
            if self.reverse:
                enc = enc[::-1]
            for b in enc:
                sid = self.nfa.add_range(b, b, -1)
                if start < 0:
                    start = sid
                for h in prev_holes:
                    self.nfa.patch(*h, sid)
                prev_holes = [(sid, 3)]
        return Frag(start, prev_holes)

    def _compile_class(self, ranges) -> Frag:
        if self.ascii_only:
            ranges = tuple((lo, min(hi, 0x7F)) for lo, hi in ranges
                           if lo < 0x80)
            if not ranges:
                sid = self.nfa.add_fail()
                return Frag(sid, [])
        # Pure-ASCII classes become a flat split of byte ranges.
        if ranges and ranges[-1][1] < 0x80:
            targets = []
            holes: List[Hole] = []
            sid_split = None
            if len(ranges) == 1:
                lo, hi = ranges[0]
                sid = self.nfa.add_range(lo, hi, -1)
                return Frag(sid, [(sid, 3)])
            children = []
            for lo, hi in ranges:
                sid = self.nfa.add_range(lo, hi, -1)
                children.append(sid)
                holes.append((sid, 3))
            sid_split = self.nfa.add_split(children)
            return Frag(sid_split, holes)

        seqs = class_to_byte_seqs(ranges, reverse=self.reverse)
        if not seqs:
            sid = self.nfa.add_fail()
            return Frag(sid, [])
        # join state so suffix chains can be shared: `cache` below is the
        # UTF-8 suffix cache (nfa/utf8_suffix.go Utf8SuffixMap analogue)
        # — identical continuation chains like [80-BF][80-BF] build once
        # per class, so the any-rune class is ~16 range states for its 9
        # byte sequences instead of 26
        join = self.nfa.add_split([-1])
        out_hole = (join, 1)
        cache = {}

        def build_seq(seq) -> int:
            # build chain from the end, sharing suffixes
            key = seq
            if key in cache:
                return cache[key]
            lo, hi = seq[0]
            if len(seq) == 1:
                sid = self.nfa.add_range(lo, hi, join)
            else:
                nxt = build_seq(seq[1:])
                sid = self.nfa.add_range(lo, hi, nxt)
            cache[key] = sid
            return sid

        children = [build_seq(seq) for seq in seqs]
        # Go-parity for invalid UTF-8: a class containing U+FFFD (any
        # negated class, `.`, \D, ...) also matches each invalid byte as a
        # single width-1 character, because Go's DecodeRune yields
        # RuneError there (reference nfa/compile.go:557-567).  Unlike the
        # reference's 0x80-0xFF branch, we exclude valid lead bytes
        # 0xC2-0xF4 so the branch can never eat the first byte of a valid
        # sequence (the reference's branch makes `^[^a][^a]\z` match the
        # single rune "é", which Go rejects); the only remaining
        # divergence is a valid lead followed by a bad continuation,
        # which needs 1-byte lookahead no NFA can express.
        if any(lo <= 0xFFFD <= hi for lo, hi in ranges):
            children.append(self.nfa.add_range(0x80, 0xC1, join))
            children.append(self.nfa.add_range(0xF5, 0xFF, join))
        # dedup preserving order
        seen = set()
        uniq = [c for c in children if not (c in seen or seen.add(c))]
        if len(uniq) == 1:
            return Frag(uniq[0], [out_hole])
        split = self.nfa.add_split(uniq)
        return Frag(split, [out_hole])

    _LOOK_MAP = {
        Op.BEGIN_LINE: Look.BEGIN_LINE,
        Op.END_LINE: Look.END_LINE,
        Op.BEGIN_TEXT: Look.BEGIN_TEXT,
        Op.END_TEXT: Look.END_TEXT,
        Op.WORD_BOUNDARY: Look.WORD_BOUNDARY,
        Op.NO_WORD_BOUNDARY: Look.NO_WORD_BOUNDARY,
    }
    _LOOK_REV = {
        Look.BEGIN_LINE: Look.END_LINE,
        Look.END_LINE: Look.BEGIN_LINE,
        Look.BEGIN_TEXT: Look.END_TEXT,
        Look.END_TEXT: Look.BEGIN_TEXT,
        Look.WORD_BOUNDARY: Look.WORD_BOUNDARY,
        Look.NO_WORD_BOUNDARY: Look.NO_WORD_BOUNDARY,
    }

    def _compile_look(self, op: Op) -> Frag:
        look = self._LOOK_MAP[op]
        if self.reverse:
            look = self._LOOK_REV[look]
        sid = self.nfa.add_look(look, -1)
        return Frag(sid, [(sid, 2)])

    def _compile_capture(self, node: Node) -> Frag:
        body = self._compile(node.subs[0])
        if not self.with_captures:
            return body
        slot_start = 2 * node.group
        slot_end = 2 * node.group + 1
        start = self.nfa.add_capture(slot_start, body.start)
        end = self.nfa.add_capture(slot_end, -1)
        for h in body.outs:
            self.nfa.patch(*h, end)
        return Frag(start, [(end, 2)])

    def _compile_concat(self, subs) -> Frag:
        frags = [self._compile(s) for s in subs]
        if not frags:
            sid = self.nfa.add_split([-1])
            return Frag(sid, [(sid, 1)])
        for a, b in zip(frags, frags[1:]):
            for h in a.outs:
                self.nfa.patch(*h, b.start)
        return Frag(frags[0].start, frags[-1].outs)

    def _compile_alternate(self, subs) -> Frag:
        frags = [self._compile(s) for s in subs]
        split = self.nfa.add_split([f.start for f in frags])
        outs: List[Hole] = []
        for f in frags:
            outs.extend(f.outs)
        return Frag(split, outs)

    def _compile_star(self, sub: Node, greedy: bool) -> Frag:
        if ast_nullable(sub):
            # x* with nullable x compiles as (x+)?: the plain loop's
            # "iterate empty, then exit" path dies at the revisited split
            # in a DFS epsilon closure, losing the empty-match-preferred
            # ordering Go's backtracking semantics require — e.g. (|a)*
            # on "aa" must match empty at 0, not "aa" (reference
            # nfa/compile.go:1313-1388 compileStarViaPlus, adapted from
            # rust-lang/regex#779).  The ? split is a fresh state, so the
            # exit after one empty iteration survives the closure.
            plus = self._compile_plus(sub, greedy)
            if greedy:
                q = self.nfa.add_split([plus.start, -1])
                hole = (q, 2)
            else:
                q = self.nfa.add_split([-1, plus.start])
                hole = (q, 1)
            return Frag(q, plus.outs + [hole])
        split = self.nfa.add_split([-1, -1])
        body = self._compile(sub)
        if greedy:
            self.nfa.patch(split, 1, body.start)
            out_hole = (split, 2)
        else:
            self.nfa.patch(split, 2, body.start)
            out_hole = (split, 1)
        for h in body.outs:
            self.nfa.patch(*h, split)
        return Frag(split, [out_hole])

    def _compile_plus(self, sub: Node, greedy: bool) -> Frag:
        body = self._compile(sub)
        split = self.nfa.add_split([-1, -1])
        if greedy:
            self.nfa.patch(split, 1, body.start)
            out_hole = (split, 2)
        else:
            self.nfa.patch(split, 2, body.start)
            out_hole = (split, 1)
        for h in body.outs:
            self.nfa.patch(*h, split)
        return Frag(body.start, [out_hole])

    def _compile_quest(self, sub: Node, greedy: bool) -> Frag:
        body = self._compile(sub)
        if greedy:
            split = self.nfa.add_split([body.start, -1])
            hole = (split, 2)
        else:
            split = self.nfa.add_split([-1, body.start])
            hole = (split, 1)
        return Frag(split, body.outs + [hole])

    def _compile_repeat(self, node: Node) -> Frag:
        sub = node.subs[0]
        m, n, greedy = node.min, node.max, node.greedy
        if n == 0:
            sid = self.nfa.add_split([-1])
            return Frag(sid, [(sid, 1)])
        parts: List[Frag] = []
        for _ in range(m):
            parts.append(self._compile(sub))
            self._check_size()
        if n == -1:
            if m == 0:
                return self._compile_star(sub, greedy)
            parts.append(self._compile_star(sub, greedy))
        else:
            # (n - m) nested optional copies: x{2,4} == xx(x(x)?)?
            tail: Optional[Frag] = None
            for _ in range(n - m):
                body = self._compile(sub)
                self._check_size()
                if tail is not None:
                    for h in body.outs:
                        self.nfa.patch(*h, tail.start)
                    inner_outs = tail.outs
                else:
                    inner_outs = body.outs
                if greedy:
                    split = self.nfa.add_split([body.start, -1])
                    hole = (split, 2)
                else:
                    split = self.nfa.add_split([-1, body.start])
                    hole = (split, 1)
                tail = Frag(split, inner_outs + [hole])
            if tail is not None:
                parts.append(tail)
        for a, b in zip(parts, parts[1:]):
            for h in a.outs:
                self.nfa.patch(*h, b.start)
        return Frag(parts[0].start, parts[-1].outs)


def compile_nfa(parsed: Parsed, reverse: bool = False,
                with_captures: bool = True,
                ascii_only: bool = False) -> NFA:
    return Compiler(reverse=reverse, with_captures=with_captures,
                    ascii_only=ascii_only).compile(parsed)
