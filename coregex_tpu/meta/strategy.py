"""Strategy selection — the meta-engine's decision tree.

Capability analogue of the reference's 17-way SelectStrategy
(meta/strategy.go:1377-1546), re-grouped for the device execution model into
families that share kernels:

  CHARCLASS     — [class]{m,k} run extraction (CharClassSearcher analogue)
  LITERAL       — exact single literal: memmem is the engine
  MULTI_LITERAL — exact alternation ≤64 literals (Teddy/AhoCorasick bypass)
  LINE_SHAPE    — universal `.*` around an inner/suffix/prefix literal,
                  incl. (?m)^prefix variants (ReverseSuffix/ReverseInner/
                  MultilineReverseSuffix universal shortcuts)
  INNER         — general inner-literal split with bidirectional DFA
                  verification (ReverseInner general path)
  FULL_SCAN     — dense DFA scans over the whole corpus (UseDFA/UseBoth)
  HOST          — PikeVM host fallback (UseNFA analogue)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

from ..syntax.ast import Node, Op
from . import literal as litmod
from . import seq as seqmod
from .literal import (UNIV_ANY, UNIV_LINE, UNIV_NONE, CharClassShape,
                      InnerSplit)


class Strategy(enum.Enum):
    CHARCLASS = "charclass"
    LITERAL = "literal"
    MULTI_LITERAL = "multi_literal"
    LINE_SHAPE = "line_shape"
    INNER = "inner"
    PREFIX_SET = "prefix_set"
    PREFIX_RUN = "prefix_run"
    END_ANCHORED = "end_anchored"
    FULL_SCAN = "full_scan"
    BITSET_NFA = "bitset_nfa"
    NULLABLE_CORE = "nullable_core"  # non-empty core spans + empty fill
    ALL_EMPTY = "all_empty"          # every match empty: boundary emission
    HOST = "host"


@dataclass
class Plan:
    strategy: Strategy
    reason: str
    literals: Optional[List[bytes]] = None
    charclass: Optional[CharClassShape] = None
    split: Optional[InnerSplit] = None
    prefix_run: Optional["litmod.PrefixRunShape"] = None
    prefix_lits: Optional[List[bytes]] = None
    nullable: bool = False
    core_ast: Optional[Node] = None  # NULLABLE_CORE: non-empty projection


def select(ast: Node, dfas_ok: bool) -> Plan:
    nullable = litmod.is_nullable(ast)

    lits = litmod.exact_literals(ast)
    if lits is not None and all(len(l) > 0 for l in lits):
        if len(lits) == 1:
            return Plan(Strategy.LITERAL, "pattern is one exact literal",
                        literals=lits, nullable=nullable)
        return Plan(Strategy.MULTI_LITERAL,
                    f"pattern is {len(lits)} exact literals",
                    literals=lits, nullable=nullable)

    cc = litmod.charclass_shape(ast)
    if cc is not None:
        return Plan(Strategy.CHARCLASS, "single-class repetition",
                    charclass=cc, nullable=nullable)

    if not dfas_ok:
        # DFA-overflow fallback tier: device bitset-NFA start discovery
        # (ops/nfa_scan.py) when the pattern is in scope.  Look-around
        # is handled by context-grouped closure tables (the lazy-DFA
        # context-expansion trick, dfa/lazy/state.go:130-176); patterns
        # needing too many context groups raise LookUnsupported at
        # scanner build and fall back to the host from the batch layer.
        # The lazy-DFA degradation of the reference
        # (dfa/lazy/lazy.go:1472-1502) keeps its scan on the CPU; this
        # keeps ours on the device.
        if not nullable:
            return Plan(Strategy.BITSET_NFA,
                        "DFA overflow; device bitset-NFA scan",
                        nullable=nullable)
        return Plan(Strategy.HOST, "DFA overflow; PikeVM only",
                    nullable=nullable)
    if nullable:
        # leftmost-first FindAll of a nullable pattern factorizes into
        # FindAll(non-empty core) + vectorized empty fill-in whenever the
        # empty match is unconditional and lowest-priority
        # (meta/nullable.py) — the core rides the normal device
        # strategies; everything else keeps the exact host walk
        from .nullable import decompose_checked
        d = decompose_checked(ast)
        if d is None:
            return Plan(Strategy.HOST, "nullable; no factorizable core",
                        nullable=True)
        if d.core is None:
            return Plan(Strategy.ALL_EMPTY,
                        "all matches empty; rune-boundary emission",
                        nullable=True)
        inner = select(d.core, dfas_ok)
        if inner.strategy in (Strategy.HOST, Strategy.NULLABLE_CORE,
                              Strategy.ALL_EMPTY):
            return Plan(Strategy.HOST,
                        f"nullable; core routes {inner.strategy.value}",
                        nullable=True)
        return Plan(Strategy.NULLABLE_CORE,
                    f"nullable core [{inner.strategy.value}] + empty fill",
                    nullable=True, core_ast=d.core)
    if litmod.has_start_anchor(ast):
        return Plan(Strategy.HOST, "start-anchored; host anchored scan",
                    nullable=nullable)
    if litmod.has_end_anchor(ast):
        # ReverseAnchoredSearcher analogue (meta/reverse_anchored.go:33):
        # every match ends at EOT, so one backward anchored-reverse scan
        # from the end finds the unique leftmost span in O(match length)
        return Plan(Strategy.END_ANCHORED,
                    "end-anchored; O(m) reverse scan from EOT",
                    nullable=nullable)

    split = litmod.inner_split(ast)
    set_at_start = False
    if split is not None and len(split.lits) > 1:
        # literal-set inner split (through alternations): multi-needle
        # candidate scan + bidirectional verification — unless the set
        # BEGINS the match, where the forward-only PREFIX_SET pipeline
        # skips the reverse pass entirely
        set_at_start = litmod.exact_literals(split.prefix_ast) is not None
        if not set_at_start:
            return Plan(Strategy.INNER,
                        f"inner literal set ({len(split.lits)} needles) "
                        "with DFA verification",
                        split=split, nullable=nullable)
    if split is not None and not set_at_start:
        up, us = split.prefix_universal, split.suffix_universal
        b_empty = split.suffix_ast.op == Op.EMPTY
        if split.line_anchored and (b_empty or us != UNIV_NONE):
            return Plan(Strategy.LINE_SHAPE, "(?m)^prefix.*lit line shape",
                        split=split, nullable=nullable)
        if up != UNIV_NONE and (b_empty or us != UNIV_NONE):
            return Plan(Strategy.LINE_SHAPE, "universal .*lit(.*) shape",
                        split=split, nullable=nullable)
        prefix_is_lit_only = split.prefix_ast.op in (Op.LITERAL,) or (
            litmod.exact_literals(split.prefix_ast) is not None)
        if us != UNIV_NONE and prefix_is_lit_only:
            return Plan(Strategy.LINE_SHAPE, "lit.* universal suffix shape",
                        split=split, nullable=nullable)

    # PREFIX_SET: every match must begin with one of ≤32 extracted prefix
    # literals (seq.py, ExtractPrefixes analogue) — candidate starts from
    # one multi-needle scan, forward-anchored DFA verification, no reverse
    # scan.  Preferred over INNER only when the pattern *starts* with the
    # split literal (the reverse pass would be a no-op); a true inner
    # literal is usually rarer than the prefixes.
    lit_at_start = split is not None and (
        split.prefix_ast.op == Op.LITERAL
        or litmod.exact_literals(split.prefix_ast) is not None)
    if split is None or lit_at_start:
        plits = seqmod.viable_prefix_set(ast)
        if plits is not None:
            return Plan(Strategy.PREFIX_SET,
                        f"match starts with one of {len(plits)} prefix "
                        "literals; forward-anchored verification",
                        prefix_lits=plits, split=split, nullable=nullable)

    if split is not None:
        return Plan(Strategy.INNER,
                    f"inner literal {split.lit!r} with DFA verification",
                    split=split, nullable=nullable)

    pr = litmod.prefix_run_shape(ast)
    if pr is not None:
        return Plan(Strategy.PREFIX_RUN,
                    "leading [class]+ run-start candidates",
                    prefix_run=pr, nullable=nullable)

    return Plan(Strategy.FULL_SCAN, "no literals; dense DFA scan",
                nullable=nullable)
