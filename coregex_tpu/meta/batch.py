"""Batch (device) execution engine: strategy pipelines over device arrays.

This is the corpus-scale execution layer: where the reference walks bytes in
a single thread (meta/find.go dispatch), this engine runs whole-corpus
vectorized prefilters + batched DFA verification and reduces spans on host.
All paths are span-exact vs the host engine (differential-tested).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dfa.determinize import DFAOverflow, determinize
from ..nfa.thompson import compile_nfa
from ..utils.corpus_cache import corpus_is_ascii
from ..utils.utf8 import go_rune_width
from ..syntax.ast import Node, Op
from ..syntax.parser import Parsed
from . import literal as litmod
from .literal import UNIV_ANY, UNIV_LINE, UNIV_NONE
from .strategy import Plan, Strategy, select

# Candidate-pipeline density gate.  The batched window machinery runs
# bounded per-launch lane batches (WindowScanner.MAX_LANES), so tens of
# millions of candidates are fine — measured on chip: 12M reverse-start
# lanes over a 1.6 GB corpus in ~34 s.  Beyond this the full-scan DFA
# sweep wins on arithmetic density.
MAX_CANDIDATES = 1 << 24
MAX_STARTS = 1 << 24


def _rune_width_np(data: np.ndarray, pos: int) -> int:
    return go_rune_width(data, pos)


# Sentinel distinct from None ("no match"): the device path is out of
# scope / failed to converge and the caller must fall back to the host
# engine.  Never test find_first results by truthiness.
FALLBACK = object()


def _empty_spans_dev():
    import jax.numpy as jnp
    return jnp.zeros((16, 2), dtype=jnp.int32)


_CHOP_JIT = None


def _chop_runs(spans, cap: int, cnt: int, mn: int, mx: int):
    """([c]{m,k})+ whole-run form applied to maximal-run spans: greedy
    k-chunks plus the remainder iff >= m (the host path's arithmetic,
    vectorized on hit-sized arrays).  Dead rows (end==start) map to
    themselves.

    The jit wrapper is module-cached: a nested @jax.jit def would be a
    NEW function object per call — zero cache hits, one fresh LLVM
    executable per call, and eventually mmap exhaustion (this crashed
    the full CPU suite with 'LLVM compilation error: Cannot allocate
    memory')."""
    global _CHOP_JIT
    if _CHOP_JIT is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("mn", "mx"))
        def chop(spans, mn: int, mx: int):
            s, e = spans[:, 0], spans[:, 1]
            L = e - s
            r = L % mx
            M = L - jnp.where(r < mn, r, 0)
            return jnp.stack([s, s + M], axis=1)

        _CHOP_JIT = chop
    return _CHOP_JIT(spans, mn, mx)


# Device dispatch serialization, scoped per jax backend (see
# utils/device_lock.py for the rationale and the crash it guards).
from ..utils.device_lock import device_lock as _device_lock


class _DeviceLockProxy:
    """Context manager resolving the CURRENT default backend's lock at
    enter time (module-import order must not freeze the backend)."""

    def __init__(self):
        import threading
        self._tl = threading.local()

    def __enter__(self):
        lk = _device_lock()
        # stack, not a slot: the lock is reentrant and so is this proxy
        getattr(self._tl, "stack", None) or setattr(self._tl, "stack", [])
        self._tl.stack.append(lk)
        lk.acquire()
        return lk

    def __exit__(self, *exc):
        self._tl.stack.pop().release()
        return False


_DEVICE_LOCK = _DeviceLockProxy()


def _device_serial(fn):
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with _device_lock():
            return fn(*a, **kw)
    return wrapped


def go_select(starts: np.ndarray, ends: np.ndarray, n: int,
              data: np.ndarray, limit: int = -1) -> np.ndarray:
    """Non-overlapping leftmost-first selection with Go allMatches
    semantics over candidate (start, end) pairs.  `starts` sorted unique
    ascending, ends aligned (end >= start)."""
    m = len(starts)
    if m == 0:
        return np.empty((0, 2), dtype=np.int64)
    # bulk fast path: no empties, no overlaps
    if limit < 0 and np.all(ends[:-1] <= starts[1:]) and np.all(ends > starts):
        return np.stack([starts, ends], axis=1).astype(np.int64)
    if np.all(ends > starts):
        # overlapping but empty-free: the restart loop is a chain walk
        # over a precomputed jump table (one vectorized searchsorted),
        # ~10x the per-step bisect of the general loop
        nxt = np.searchsorted(starts, ends, side="left").tolist()
        sel: List[int] = []
        i = 0
        while i < m and (limit < 0 or len(sel) < limit):
            sel.append(i)
            i = nxt[i]
        idx = np.asarray(sel, dtype=np.int64)
        return np.stack([starts[idx], ends[idx]], axis=1).astype(np.int64)
    out: List[Tuple[int, int]] = []
    pos = 0
    prev_end = -1
    i = 0
    while pos <= n and (limit < 0 or len(out) < limit):
        i = int(np.searchsorted(starts, pos, side="left"))
        if i >= m:
            break
        s = int(starts[i])
        e = int(ends[i])
        accept = True
        if e == pos:
            if s == prev_end:
                accept = False
            pos += _rune_width_np(data, pos)
        else:
            pos = e
        prev_end = e
        if accept:
            out.append((s, e))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def _bulk_count_kernel(starts, ends, data, class_tbl, n):
    """Device bulk selection check: (count, overlap, pending).

    starts sorted ascending (padding entries have end == -1); overlap means
    greedy selection would drop some candidate; pending means some match
    end lands mid-run (a restart start not in the candidate set)."""
    import jax

    @jax.jit
    def kernel(starts, ends, data, class_tbl, n):
        import jax.numpy as jnp
        valid = ends >= 0
        e = jnp.where(valid, ends, -1).astype(jnp.int32)
        prevmax = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), jax.lax.cummax(e)[:-1]])
        overlap = jnp.any(valid & (starts < prevmax))
        ei = jnp.clip(e, 1, n - 1)
        in_cls = class_tbl[data[ei]] & class_tbl[data[ei - 1]]
        pending = jnp.any(valid & (e > 0) & (e < n) & in_cls)
        return valid.sum(dtype=jnp.int32), overlap, pending

    return kernel(starts, ends, data, class_tbl, n)


def _line_count_kernel_factory():
    """Fused one-launch line-shape count, keyed on (lit, prefix, anchored)
    statics so all corpora share compiles."""
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit,
                       static_argnames=("lit", "prefix", "line_anchored"))
    def kernel(data, lit, prefix, line_anchored):
        from ..ops.bytescan import _memmem_mask, line_bound_arrays
        n = data.shape[0]
        k = len(lit)
        cand = _memmem_mask(data, lit)
        prev_nl, next_nl = line_bound_arrays(data)
        idxs = jnp.arange(n, dtype=jnp.int32)
        valid = cand & (idxs + k <= next_nl)
        if line_anchored and len(prefix):
            prefix_at = _memmem_mask(data, prefix)
            prev_byte = jnp.concatenate(
                [jnp.zeros(1, dtype=data.dtype), data[:-1]])
            is_ls = (idxs == 0) | (prev_byte == np.uint8(10))
            lg = jax.lax.cummax(jnp.where(is_ls & prefix_at, idxs, -1))
            line_good = lg == (prev_nl + 1)
            valid = valid & line_good & (idxs >= prev_nl + 1 + len(prefix))
        pv = jax.lax.cummax(jnp.where(valid, idxs, -1))
        pv_excl = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), pv[:-1]])
        first_in_line = valid & (pv_excl <= prev_nl)
        return first_in_line.sum(dtype=jnp.int32)

    return kernel


_line_count_kernel = None


def _prefix_run_cand_kernel_factory():
    """Fused candidate mask + count for PREFIX_RUN (class ranges + sieve
    statics)."""
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("cls_ranges", "sieve"))
    def kernel(data, cls_ranges, sieve):
        from ..ops.bytescan import _range_mask, _run_masks
        from ..ops.sieve import sieve_mask
        mask = _range_mask(data, cls_ranges)
        smask, _ = _run_masks(mask)
        if sieve:
            smask = smask & sieve_mask(data, sieve)
        return smask, smask.sum(dtype=jnp.int32)

    return kernel


_prefix_run_cand_kernel = None


def _line_cand_bounds_factory():
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("k", "prefix"))
    def kernel(dev, cand, nl, n, k: int, prefix):
        """Per-candidate validity + line bounds.  cand/nl are compacted
        position arrays (sentinel-filled with n past their counts)."""
        c = jnp.minimum(cand, n - 1)
        idx = jnp.searchsorted(nl, c, side="left")
        le = jnp.where(idx < nl.shape[0],
                       nl[jnp.minimum(idx, nl.shape[0] - 1)], n)
        le = jnp.minimum(le, n)
        ls = jnp.where(idx > 0,
                       nl[jnp.maximum(idx - 1, 0)] + 1, 0)
        valid = (cand < n) & (cand + k <= le)
        plen = len(prefix)
        if plen:
            offs = jnp.arange(plen, dtype=jnp.int32)
            w = dev[jnp.minimum(ls[:, None] + offs[None, :], n - 1)]
            pv = jnp.asarray(np.array(prefix, dtype=np.uint8))
            pfx_ok = jnp.all(w == pv[None, :], axis=1) & (ls + plen <= n)
            valid = valid & pfx_ok & (cand >= ls + plen)
        return valid, ls, le

    return kernel


def _line_cand_bounds(*args, **kw):
    global _line_cand_bounds_fn
    try:
        fn = _line_cand_bounds_fn
    except NameError:
        fn = None
    if fn is None:
        fn = _line_cand_bounds_factory()
        _line_cand_bounds_fn = fn
    return fn(*args, **kw)


class BatchEngine:
    """Per-pattern batch execution plan + device artifacts."""

    def __init__(self, parsed: Parsed, ast: Node, dfas_ok: bool,
                 longest: bool = False, stats=None, host_find=None):
        self.parsed = parsed
        self.ast = ast
        self.longest = longest
        self.stats = stats  # Engine.Stats for prefilter hit/miss counters
        self.host_find = host_find  # (arr, pos) -> span | None (PikeVM)
        self.plan: Plan = select(ast, dfas_ok)
        if longest and self.plan.strategy in (Strategy.NULLABLE_CORE,
                                              Strategy.ALL_EMPTY):
            # the nullable factorization (dead-branch cut, greedy-chain
            # argument) is leftmost-first only; POSIX longest keeps the
            # exact host walk
            self.plan = Plan(Strategy.HOST, "nullable (longest): host",
                             nullable=True)
        self._core_engine = None  # lazy sub-engine over plan.core_ast
        if longest and self.plan.strategy == Strategy.MULTI_LITERAL:
            # POSIX picks the longest alternative at a position, not the
            # first: reorder the literal priority by length (stable)
            self.plan.literals = sorted(
                self.plan.literals, key=len, reverse=True)
        self._ddfa_cache: Dict[str, object] = {}
        self._host_dense: Dict[str, object] = {}
        self._sieve = None
        self._count_sc = None  # lazy CountScanner; False == unavailable
        self._bitset_fwd = None  # lazy BitsetNFAScanner; False == out of scope
        self._bitset_rev = None
        self._count_sc_ascii = None  # lazy ASCII-projected CountScanner
        self._sharded_sc = {}  # ShardedGoCount per count scanner
        self.served_by = None  # path that answered the last call
        self._pf_hits = 0  # runtime prefilter tracker (tracker.go:37)
        self._pf_seen = 0
        self._pf_retired = False
        # per-corpus-fingerprint match counts: sizes warm find_all
        # compaction caps without a count sync (find_all_spans_device)
        self._spans_cnt_cache = {}
        # FlagResetScanner per (dfa kind, reset ctx) — extended-alphabet
        # tables built once per engine
        self._flag_scanner_cache = {}
        # bidirectional span path (lazy scanners + per-call corpus info)
        self._span_sc = None
        self._span_sc_ascii = None
        self._bidi_ascii = False
        self._bidi_data = None
        self._rev_hint_cache = {}  # corpus fp -> reverse-scan lane entries
        self._sym_tiles_cache = {}  # reset-free reverse symbol tiles

    def _verify_kind(self) -> str:
        """Anchored verification DFA: leftmost-first uses break-at-match;
        POSIX longest keeps all matches and takes the last flag."""
        return "fwd_anch_all" if self.longest else "fwd_anch_break"

    # -- artifact builders (lazy) ---------------------------------------
    def _dense(self, kind: str):
        if kind in self._ddfa_cache:
            return self._ddfa_cache[kind]
        from ..utils.artifact_cache import load_dense, save_dense
        cached = load_dense(self.parsed.pattern, kind)
        if cached is not None:
            from ..ops.dfa_scan import DeviceDFA
            dd = DeviceDFA.from_dense(cached)
            self._ddfa_cache[kind] = dd
            self._host_dense[kind] = cached
            return dd
        if kind == "fwd_all":
            nfa = compile_nfa(self.parsed, with_captures=False)
            d = determinize(nfa, anchored=False, break_at_match=False)
        elif kind == "fwd_break":
            # unanchored leftmost-first DFA: dies right after the leftmost
            # match is complete, so "last flag" == leftmost-first end
            nfa = compile_nfa(self.parsed, with_captures=False)
            d = determinize(nfa, anchored=False, break_at_match=True)
        elif kind == "rev_anch":
            # anchored reverse DFA: match must end exactly at the scan
            # origin (find_rev_start analogue, dfa/search.py:55)
            nfa = compile_nfa(self.parsed, reverse=True)
            d = determinize(nfa, anchored=True, break_at_match=False,
                            reverse=True)
        elif kind == "rev_anch_ascii":
            # ASCII-projected anchored reverse DFA (exact when every
            # corpus byte < 0x80): 3-6 byte classes instead of the
            # 15-25 of the rune automaton — the same projection the
            # count scanner uses (meta/compile.go:386-430 analogue)
            nfa = compile_nfa(self.parsed, reverse=True,
                              ascii_only=True)
            d = determinize(nfa, anchored=True, break_at_match=False,
                            reverse=True)
        elif kind == "rev_all":
            nfa = compile_nfa(self.parsed, reverse=True)
            d = determinize(nfa, anchored=False, break_at_match=False,
                            reverse=True)
        elif kind == "fwd_anch_break":
            nfa = compile_nfa(self.parsed, with_captures=False)
            d = determinize(nfa, anchored=True, break_at_match=True)
        elif kind == "fwd_anch_all":
            nfa = compile_nfa(self.parsed, with_captures=False)
            d = determinize(nfa, anchored=True, break_at_match=False)
        elif kind in ("fwd_suffix", "fwd_suffix_all"):
            # anchored DFA of the inner split's SUFFIX ast: the suffix
            # extent engine for the reset-scan (leftmost-first uses
            # break-at-match "last flag before death"; POSIX longest
            # keeps all flags)
            sub = Parsed(self.plan.split.suffix_ast, 0, [],
                         self.parsed.pattern + "<suffix>")
            nfa = compile_nfa(sub, with_captures=False)
            d = determinize(nfa, anchored=True,
                            break_at_match=(kind == "fwd_suffix"))
        elif kind == "rev_prefix":
            # reverse DFA of (A · lit) for inner-candidate start discovery
            sub = Parsed(self.plan.split.prefix_ast, 0, [],
                         self.parsed.pattern + "<prefix>")
            nfa = compile_nfa(sub, reverse=True)
            d = determinize(nfa, anchored=True, break_at_match=False,
                            reverse=True)
        else:
            raise KeyError(kind)
        from ..ops.dfa_scan import DeviceDFA
        save_dense(self.parsed.pattern, kind, d)
        dd = DeviceDFA.from_dense(d)
        self._ddfa_cache[kind] = dd
        self._host_dense[kind] = d
        return dd

    def _sieve_ranges(self):
        """Cached offset byte-range sieve from the anchored DFA."""
        if self._sieve is None:
            from ..ops.sieve import offset_byte_ranges
            kind = self._verify_kind()
            self._dense(kind)
            self._sieve = offset_byte_ranges(self._host_dense[kind])
        return self._sieve

    # -- public entry points --------------------------------------------
    @_device_serial
    def find_all_spans(self, data: np.ndarray, limit: int = -1
                       ) -> np.ndarray:
        """All non-overlapping spans with Go semantics; data is host uint8."""
        from ..utils.corpus_cache import device_corpus
        n = len(data)
        if limit < 0:
            r = self.find_all_spans_device(data)
            if r is not None:
                import jax
                spans_dev, cnt = r
                if cnt == 0:
                    return np.empty((0, 2), dtype=np.int64)
                return np.asarray(
                    jax.device_get(spans_dev[:cnt])).astype(np.int64)
        dev = device_corpus(data)
        strat = self.plan.strategy
        self.served_by = "pipeline:" + strat.name.lower()
        if strat == Strategy.CHARCLASS:
            return self._charclass_spans(dev, n, limit)
        if strat == Strategy.LITERAL:
            return self._literal_spans(dev, data, n, limit)
        if strat == Strategy.MULTI_LITERAL:
            return self._multi_literal_spans(dev, data, n, limit)
        if strat == Strategy.LINE_SHAPE:
            return self._line_shape_spans(dev, data, n, limit)
        if strat == Strategy.INNER:
            return self._inner_spans(dev, data, n, limit)
        if strat == Strategy.PREFIX_SET:
            return self._prefix_set_spans(dev, data, n, limit)
        if strat == Strategy.PREFIX_RUN:
            return self._prefix_run_spans(dev, data, n, limit)
        if strat == Strategy.END_ANCHORED:
            return self._end_anchored_spans(data, n)
        if strat == Strategy.FULL_SCAN:
            return self._full_scan_spans(dev, data, n, limit)
        if strat == Strategy.BITSET_NFA:
            return self._bitset_spans(dev, data, n, limit)  # None = host
        if strat == Strategy.ALL_EMPTY:
            from .nullable import all_empty_spans
            return all_empty_spans(n, data, limit)
        if strat == Strategy.NULLABLE_CORE:
            return self._nullable_core_spans(data, n, limit)
        raise RuntimeError("host strategy should not reach BatchEngine")

    # -- device-resident span assembly -----------------------------------
    # Spans as [cap,2] int32 DEVICE arrays.  Round 5: the sparse-chain
    # families (ops/span_chain.py) run bool-only mask algebra fused into
    # word-packing, so their footprint is corpus + n/8 words + hit-sized
    # buffers — they extract at full corpus scale, gated only by the
    # span-count cap below.  Families still on the round-4 pipelines
    # (line shapes, INNER, candidate verification) hold corpus-sized
    # int32 intermediates and keep the 448 MB corpus limit.  Both
    # env-tunable for experiments.
    DEVICE_SPANS_LIMIT = int(os.environ.get(
        "COREGEX_TPU_DEV_SPANS_LIMIT", str(448 * 1024 * 1024)))
    SPARSE_SPANS_LIMIT = int(os.environ.get(
        "COREGEX_TPU_SPARSE_SPANS_LIMIT", str(1600 * 1024 * 1024)))
    # device span assembly is output-bound too: each span costs ~28
    # bytes across the result + chain buffers; past this count the host
    # chunked pipelines take over (they stream any size)
    MAX_DEVICE_SPANS = int(os.environ.get(
        "COREGEX_TPU_MAX_DEV_SPANS", str(128 * 1024 * 1024)))

    _SPARSE_FAMILIES = ("LITERAL", "MULTI_LITERAL", "CHARCLASS",
                        "NULLABLE_CORE", "LINE_SHAPE", "INNER",
                        "PREFIX_RUN", "PREFIX_SET", "FULL_SCAN")

    def _spans_limit(self, strat) -> int:
        if strat.name in self._SPARSE_FAMILIES:
            return self.SPARSE_SPANS_LIMIT
        return self.DEVICE_SPANS_LIMIT

    def _resolve_cnt(self, cnt_dev, known_cnt, fp=None):
        """(host count for cap sizing, count to return).  Cold path
        syncs (and caches under the corpus fingerprint); warm path
        (known_cnt from the cache) skips the sync and returns the
        DEVICE scalar for the caller to fold into its own final sync —
        the chains' ok flag still catches any cap overflow if the cache
        were ever stale."""
        if known_cnt is None:
            import jax
            c = int(jax.device_get(cnt_dev))
            if fp is not None:
                self._spans_cnt_cache[fp] = c
            return c, c
        return known_cnt, cnt_dev

    # strategies whose builders accept known_cnt (warm sync-free path)
    _WARM_FAMILIES = ("LITERAL", "MULTI_LITERAL", "CHARCLASS",
                      "LINE_SHAPE", "INNER", "PREFIX_RUN",
                      "PREFIX_SET", "FULL_SCAN")

    def find_all_spans_device(self, data: np.ndarray,
                              defer_ok: bool = False):
        """(spans_dev [cap,2] int32, count int) or None (out of scope /
        validation failed -> host pipelines).  With defer_ok=True,
        returns (spans_dev, count, ok) where ok is a DEVICE bool (or
        None when the builder validated internally) and count may be a
        DEVICE scalar on the warm path: the caller folds both into its
        own final sync instead of paying one here.  Warm = this engine
        already extracted on a corpus with the same fingerprint, whose
        cached count sizes the compaction caps sync-free."""
        import jax
        from ..utils.corpus_cache import _fingerprint, device_corpus
        n = len(data)
        strat = self.plan.strategy
        if n == 0 or n > self._spans_limit(strat):
            return None
        builders = {
            Strategy.CHARCLASS: self._charclass_spans_dev,
            Strategy.LITERAL: self._literal_spans_dev,
            Strategy.MULTI_LITERAL: self._multi_literal_spans_dev,
            Strategy.LINE_SHAPE: self._line_shape_spans_dev,
            Strategy.PREFIX_RUN: self._prefix_family_spans_dev,
            Strategy.PREFIX_SET: self._prefix_family_spans_dev,
            Strategy.FULL_SCAN: self._bidi_spans_dev,
            Strategy.BITSET_NFA: self._bitset_nfa_spans_dev,
            Strategy.INNER: self._inner_family_spans_dev,
        }
        b = builders.get(strat)
        if b is None and strat != Strategy.NULLABLE_CORE:
            return None
        warm = strat.name in self._WARM_FAMILIES
        fp = _fingerprint(data) if warm else None
        known = self._spans_cnt_cache.get(fp) if (warm and defer_ok) \
            else None
        if strat in (Strategy.PREFIX_RUN, Strategy.PREFIX_SET,
                     Strategy.FULL_SCAN, Strategy.BITSET_NFA,
                     Strategy.INNER):
            # span-transducer scanner choice (ASCII-projected tables
            # when the corpus allows; verdict cached per device buffer)
            self._bidi_ascii = corpus_is_ascii(data)
            self._bidi_data = data
        with _DEVICE_LOCK:
            try:
                if b is None:
                    r = self._nullable_spans_dev(data, n)
                elif warm:
                    dev = device_corpus(data)
                    r = b(dev, n, known_cnt=known, fp=fp)
                else:
                    dev = device_corpus(data)
                    r = b(dev, n)
            except DFAOverflow:
                return None
            if r is None:
                return None
            self.served_by = "device:" + (
                b.__name__ if b is not None else "_nullable_spans_dev")
            if len(r) == 2:  # round-4 builders validate internally
                spans, cnt = r
                ok = None
            else:
                spans, cnt, ok = r
            if defer_ok:
                return spans, cnt, ok
            if ok is not None and not bool(jax.device_get(ok)):
                return None
            return spans, cnt

    def _nullable_spans_dev(self, data, n):
        """Device-resident nullable FindAll for [class]+ cores
        (`\\w*`-family, ASCII corpora): the factorization's matches form
        an ALIGNED MASK PAIR — starts = run starts ∪ accepted empties,
        ends = (run ends + 1) ∪ the same empties — disjoint bit sets in
        strictly interleaved order, so two compactions assemble the
        merged span list with no sort and no gathers.  (Empties sit at
        positions that are neither members nor a run's exclusive end —
        exactly meta/nullable.py's fill rule specialized to min=1
        class runs; ASCII makes every position a rune boundary.)"""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import (_bucket, _class_mask_from_table,
                                    mask_count)
        from ..ops.compact import compact_positions
        from ..utils.corpus_cache import device_corpus
        eng = self._core()
        be = eng.batch_engine()
        plan = be.plan
        cc = plan.charclass
        if (plan.strategy != Strategy.CHARCLASS or cc is None
                or cc.min != 1 or cc.max != -1 or cc.plus
                or not corpus_is_ascii(data)):
            # general cores / UTF-8 corpora: core spans from the core
            # engine's own device builder + device fill (round 5)
            return self._nullable_general_spans_dev(be, data, n)
        dev = device_corpus(data)
        member = _class_mask_from_table(dev, np.array(cc.table,
                                                     dtype=bool))
        member_ext = jnp.concatenate([member, jnp.zeros(1, bool)])
        prev_m = jnp.concatenate([jnp.zeros(1, bool), member_ext[:-1]])
        runstart = member_ext & ~prev_m
        runend1 = prev_m & ~member_ext     # exclusive end of each run
        empties = ~member_ext & ~runend1
        smask = runstart | empties
        emask = runend1 | empties
        total = int(jax.device_get(mask_count(smask)))
        if total == 0:
            return _empty_spans_dev(), 0
        cap = _bucket(total, 16)
        starts, cs = compact_positions(smask, cap)
        ends, ce = compact_positions(emask, cap)
        if not bool(jax.device_get(cs == ce)):  # pragma: no cover
            return None
        return jnp.stack([starts, ends], axis=1), total

    def _nullable_general_spans_dev(self, core_be, data, n):
        """Device nullable FindAll for GENERAL cores and UTF-8 corpora
        (round 5, verdict item 6): the core's spans come from its own
        device builder (any family), and the empty fill-in — rune
        boundaries minus covered intervals minus core ends
        (meta/nullable.py:fill_empties) — runs as device algebra with a
        chain compaction of the empties and a searchsorted merge.
        Reference: one streaming loop for all of it,
        meta/findall.go:176-283."""
        import jax
        from ..ops.bytescan import _bucket
        from ..ops.compact2 import _bucket_up, sparse_positions_words
        from ..ops.span_chain import (_dev_i32, nullable_fill_words,
                                      nullable_merge)
        from ..utils.corpus_cache import device_corpus
        if n < 4 or n > self.DEVICE_SPANS_LIMIT:
            return None
        if core_be.plan.strategy == Strategy.HOST:
            return None
        r = core_be.find_all_spans_device(data)
        if r is None:
            return None
        spans_c, cnt_c = r
        dev = device_corpus(data)
        nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
        Bw, ne_d = nullable_fill_words(spans_c, _dev_i32(cnt_c), dev,
                                       corpus_is_ascii(data), nwb1)
        ne = int(jax.device_get(ne_d))
        total = cnt_c + ne
        if total > self.MAX_DEVICE_SPANS:
            return None
        if ne == 0:
            return spans_c, cnt_c
        capK = _bucket(ne, 16)
        emp_pos, ke, ok1 = sparse_positions_words(Bw, n + 1, capK)
        capT = _bucket(total, 16)
        spans, total_d = nullable_merge(spans_c, _dev_i32(cnt_c),
                                        emp_pos, ne_d, _dev_i32(n),
                                        capT)
        if not bool(jax.device_get(ok1 & (ke == ne_d))):
            return None  # pragma: no cover - chain contract broken
        return spans, total

    def _literal_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """One fused mask->words dispatch + count sync + sparse chain:
        extraction cost ~ matches, not corpus (round 5; the reference's
        scan-and-append loop is meta/findall.go:176-283)."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, literal_self_overlaps
        from ..ops.span_chain import (SPARSE_OK, literal_words,
                                      literal_spans_sparse)
        lit = self.plan.literals[0]
        k = len(lit)
        if literal_self_overlaps(lit):
            return None  # overlap selection: host walk
        words, cnt_dev = literal_words(dev, tuple(lit))
        cnt, ret_cnt = self._resolve_cnt(cnt_dev, known_cnt, fp)
        if cnt == 0:
            return _empty_spans_dev(), 0, None
        if cnt > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cnt, 16)
        if cnt / n < SPARSE_OK:
            spans, _, ok = literal_spans_sparse(words, n, cap, k)
        else:  # dense hits: single-level kernel over the rebuilt mask
            from ..ops.bytescan import _memmem_mask
            from ..ops.compact2 import compact_pay
            starts, _, ok = compact_pay(_memmem_mask(dev, tuple(lit)),
                                        (), cap)
            live = jnp.arange(cap, dtype=jnp.int32) < cnt
            ends = jnp.where(live, starts + k, starts)
            spans = jnp.stack([starts, ends], axis=1)
        return spans, ret_cnt, ok

    def _charclass_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """Run masks fused into word-packing + count sync + two sparse
        chains (round 5); the {m,k}+ chopping arithmetic stays a
        hit-sized XLA epilogue."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, table_to_ranges
        from ..ops.span_chain import (SPARSE_OK, class_run_words,
                                      pair_spans_sparse)
        cc = self.plan.charclass
        plain = cc.min == 1 and cc.max == -1 and not cc.plus
        if not (plain or cc.plus):
            return None  # general {m,k} chopping: host
        mmin = cc.min if (cc.plus and cc.min > 1) else 1
        ranges = table_to_ranges(np.array(cc.table, dtype=bool))
        ws, we, cs_dev, ce_dev = class_run_words(dev, ranges, mmin)
        cnt, ret_cnt = self._resolve_cnt(cs_dev, known_cnt, fp)
        if cnt == 0:
            return _empty_spans_dev(), 0, None
        if cnt > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cnt, 16)
        if cnt / n < SPARSE_OK:
            spans, _, ok = pair_spans_sparse(ws, we, n, n, cap,
                                             end_adjust=1)
        else:
            spans, ok = self._charclass_dense_pair(dev, ranges, mmin,
                                                   cap, cnt)
        if not plain:
            # ([c]{m,k})+ whole-run form: greedy k-chunks + remainder
            # iff >= m (same arithmetic as the host path, vectorized)
            spans = _chop_runs(spans, cap, cnt, cc.min, cc.max)
        return spans, ret_cnt, ok

    @staticmethod
    def _charclass_dense_pair(dev, ranges, mmin, cap, cnt):
        """Dense-run fallback: single-level compaction over the full
        masks (charclass_w-style corpora where every other byte starts
        a run and the sparse chain degenerates)."""
        import jax.numpy as jnp
        from ..ops.bytescan import _range_mask
        from ..ops.compact2 import compact_pay
        from ..ops.span_chain import class_run_masks_dense
        smask, emask = class_run_masks_dense(dev, ranges, mmin)
        starts, _, ok1 = compact_pay(smask, (), cap)
        lasts, _, ok2 = compact_pay(emask, (), cap)
        live = jnp.arange(cap, dtype=jnp.int32) < cnt
        ends = jnp.where(live, lasts + 1, starts)
        return jnp.stack([starts, ends], axis=1), ok1 & ok2

    def _multi_literal_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """All-bool win-mask algebra fused into word-packing + count
        sync + two sparse chains (round 5); alignment validation (the
        overlapping-hits -> host-walk gate) rides the chains' ok flag."""
        import jax
        from ..ops.bytescan import _bucket
        from ..ops.span_chain import (MULTI_FUSED_LIMIT, SPARSE_OK,
                                      multi_literal_words,
                                      multi_literal_words_big,
                                      pair_spans_sparse)
        lits = tuple(tuple(l) for l in self.plan.literals)
        producer = (multi_literal_words if n <= MULTI_FUSED_LIMIT
                    else multi_literal_words_big)
        ws, we, cs_dev, ce_dev = producer(dev, lits)
        if known_cnt is None:
            cnt, cnte = (int(x) for x in
                         jax.device_get((cs_dev, ce_dev)))
            ret_cnt = cnt
            if cnt and cnt != cnte:
                return None  # overlapping hits: host selection walk
            if fp is not None:
                self._spans_cnt_cache[fp] = cnt
        else:  # warm: same corpus fingerprint -> same verdicts
            cnt, ret_cnt = known_cnt, cs_dev
        if cnt == 0:
            return _empty_spans_dev(), 0, None
        if cnt > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cnt, 16)
        if cnt / n >= SPARSE_OK:
            return None  # denser than any real literal corpus: host
        spans, _, ok = pair_spans_sparse(ws, we, n, n + 1, cap)
        if known_cnt is None:
            if not bool(jax.device_get(ok)):
                return None  # overlapping hits: host selection walk
            return spans, cnt, None
        return spans, ret_cnt, ok

    def _line_shape_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """Line-shape extraction on the EVENT STREAM (round 5): one
        fused producer packs (newline, candidate, anchored-line-start)
        masks to words; the sparse chain compacts them into a
        position-ordered event stream; all per-line logic (first/last
        candidate, prefix gating, BOL/EOL endpoints) is hit-sized array
        algebra; one payload compaction emits the spans.  Replaces the
        round-4 corpus-sized cummax cascades (line_span_masks) that
        cost ~0.7 s per 256 MB and OOMed past 448 MB."""
        import jax
        from ..ops.bytescan import _bucket
        from ..ops.span_chain import (line_event_words,
                                      line_spans_candidates)
        sp = self.plan.split
        a_univ, b_empty, b_univ, a_is_empty = self._line_shape_parts(sp)
        if a_univ == UNIV_ANY or b_univ == UNIV_ANY:
            return None  # single-match shapes: host path is trivial
        mode = ("first_to_eol" if a_is_empty
                else "bol_to_last" if b_empty else "bol_to_eol")
        lit = bytes(sp.lit)
        prefix = bytes(sp.prefix_literal) if sp.line_anchored else b""
        if b"\n" in lit or b"\n" in prefix or not lit:
            return None  # event masks assume newline-free needles
        words, cnts = line_event_words(dev, tuple(lit), tuple(prefix),
                                       sp.line_anchored)
        # round 5b: the chain compacts CANDIDATES only (newlines ride
        # as per-word payload tables), so the cap scales with lit hits
        # instead of every newline in the corpus
        if known_cnt is None:
            cand_total = int(jax.device_get(cnts[1]))
            if fp is not None:
                self._spans_cnt_cache[fp] = cand_total
        else:
            cand_total = known_cnt
        if cand_total == 0:
            return _empty_spans_dev(), 0, None
        if cand_total > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cand_total, 16)
        spans, cntm_dev, ok = line_spans_candidates(
            list(words), n, cap, mode, sp.line_anchored, len(lit),
            len(prefix))
        if known_cnt is None:
            cntm, okh = (int(x) for x in
                         jax.device_get((cntm_dev, ok)))
            if not okh:
                return None  # pragma: no cover - invariant broken
            if cntm == 0:
                return _empty_spans_dev(), 0, None
            return spans, cntm, None
        return spans, cntm_dev, ok

    @staticmethod
    def _class_run_prefix(prefix_ast, lit: bytes):
        """(table[256], m, M) when prefix_ast is [class]{m,M}-ish · lit
        with m >= 1 and lit[0] outside the class — the shape whose viable
        match starts form the member run abutting each lit occurrence
        (every suffix of the run of length in [m, M] is a start).  None
        otherwise."""
        from ..syntax.ast import Op
        node = litmod._uncap(prefix_ast)
        if node.op != Op.CONCAT or len(node.subs) != 2:
            return None
        rep, tail = litmod._uncap(node.subs[0]), node.subs[1]
        if tail.op != Op.LITERAL or bytes(
                bytearray(tail.runes)) != lit:
            return None
        if rep.op == Op.PLUS and rep.greedy:
            m, M = 1, -1
        elif rep.op == Op.REPEAT and rep.greedy and rep.min >= 1:
            m, M = rep.min, rep.max
        else:
            return None
        if m > 16:
            return None
        t = litmod.ascii_class_table(litmod._uncap(rep.subs[0]))
        if t is None or t[lit[0]]:
            return None
        return np.array(t, dtype=bool), m, M

    def _inner_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """INNER family with a class-run prefix (email/url shapes),
        round 5: one fused candidate producer (member/lit masks packed
        to words + per-word last-nonmember table), one suffix
        ResetScanner pass (resets at candidate+k), two payload chains
        (candidates with member-word tables; resets with flag-word
        tables), then per-candidate bit math + flexible Go selection —
        everything after the scan is hit-sized, gather-free, and
        corpus-int32-free (the round-4 path held several corpus cummin
        arrays and three compactions).  Cold path: two syncs (candidate
        count, final ok); warm path: sync-free with deferred ok.
        Reference analogue: meta/reverse_inner.go:324-418."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, table_to_ranges
        from ..ops.compact2 import sparse_chain_payloads
        from ..ops.span_chain import (_dev_i32, _shift_words,
                                      inner_assemble,
                                      inner_cand_arrays)
        from ..syntax.ast import Op
        if self._pf_retired:
            return None
        sp = self.plan.split
        if len(sp.lits) != 1:
            return None
        shape = self._class_run_prefix(sp.prefix_ast, sp.lit)
        if shape is None:
            return None
        table, m, M = shape
        lit, k = sp.lit, len(sp.lit)
        b_empty = sp.suffix_ast.op == Op.EMPTY
        if not b_empty and litmod.is_nullable(sp.suffix_ast):
            return None
        ranges = table_to_ranges(np.array(table, dtype=bool))
        # suffix scanner built early: the candidate producer fuses the
        # flag scan's symbol stream into its corpus pass
        fsc = None
        if not b_empty and not litmod.has_looks(sp.suffix_ast):
            from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_WORD
            from ..ops.flag_scan import FlagResetScanner
            kind = "fwd_suffix" if not self.longest else \
                "fwd_suffix_all"
            b_last = lit[-1]
            rctx = (CTX_WORD if (48 <= b_last <= 57
                                 or 65 <= b_last <= 90 or b_last == 95
                                 or 97 <= b_last <= 122)
                    else CTX_NL if b_last == 10 else CTX_OTHER)
            try:
                fsc = self._flag_scanner_cache.get((kind, rctx))
                if fsc is None:
                    fsc = FlagResetScanner(self._dense(kind), rctx)
                    self._flag_scanner_cache[(kind, rctx)] = fsc
            except ValueError:
                return None  # > 64 byte-segments: symbol packing gate
        if fsc is not None:
            from ..ops.span_chain import inner_cand_symbols
            candw, mw, lastnm_w, syms, cnt_dev = inner_cand_symbols(
                dev, ranges, tuple(lit), m, fsc.byte_bounds())
        else:
            candw, mw, lastnm_w, rmask, cnt_dev = inner_cand_arrays(
                dev, ranges, tuple(lit), m)
        if known_cnt is None:
            cnt = int(jax.device_get(cnt_dev))
            if fp is not None:
                self._spans_cnt_cache[fp] = cnt
        else:
            cnt = known_cnt
        if cnt == 0:
            return _empty_spans_dev(), 0, None
        if cnt > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cnt, 16)
        outA = sparse_chain_payloads(candw, [mw, lastnm_w], n, cap)
        c_pos, mw_i, lastnm_i, cntA, okA = outA
        if b_empty:
            # no suffix: every candidate verified, end = c + k
            live = jnp.arange(cap, dtype=jnp.int32) < cntA
            ends = jnp.where(live, c_pos + k, jnp.int32(0))
            spans, nsel_dev, ok = inner_assemble(
                c_pos, mw_i, lastnm_i, c_pos, mw_i, lastnm_i, cntA,
                cntA, okA, jnp.int32(0), jnp.bool_(True),
                jnp.bool_(False), _dev_i32(n), cap, k, m, M,
                b_empty=True, fixed_ends=ends)
        else:
            if fsc is None:
                return None  # looks in suffix: EOI undecidable in-scan
            from ..ops.compact2 import _bucket_up
            from ..ops.span_chain import inner_flag_arrays_words
            fw_raw, interf_cnt, conv, _h = fsc.scan_words_syms(syms, n)
            nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
            flagw, lastflag_w, glob_lf = inner_flag_arrays_words(
                fw_raw, nwb1)
            rw = _shift_words(candw, k, nwb1)
            outB = sparse_chain_payloads(rw, [flagw, lastflag_w],
                                         n + 1, cap)
            r_pos, flagw_i, lastflag_i, cntB, okB = outB
            spans, nsel_dev, ok = inner_assemble(
                c_pos, mw_i, lastnm_i, r_pos, flagw_i, lastflag_i,
                cntA, cntB, okA & okB, glob_lf,
                conv & (interf_cnt == 0), jnp.bool_(False),
                _dev_i32(n), cap, k, m, M)
        if known_cnt is None:
            nsel, okh = (int(x) for x in
                         jax.device_get((nsel_dev, ok)))
            if not okh:
                return None  # interference / non-convergence: host
            if nsel == 0:
                return _empty_spans_dev(), 0, None
            return spans, nsel, None
        return spans, nsel_dev, ok


    # -- bidirectional event-stream extraction (round 5) ----------------
    # Forward span-transducer scan (ends) + reverse-anchored reset scan
    # (starts): two count-kernel-speed corpus passes + hit-sized chain
    # assembly, for ANY pattern whose count transducer is spans_simple —
    # the PREFIX_RUN/PREFIX_SET families (ip/version) and FULL_SCAN
    # (including >64-literal alternations through the dense DFA).  The
    # lane-parallel form of the reference's 2-pass bidirectional FindAll
    # fast path (meta/findall.go:216-239).

    def _span_scanner(self, ascii_ok: bool):
        """Lazy SpanScanner over the span-event transducer (False when
        out of scope: no count transducer or not spans_simple)."""
        slot = "_span_sc_ascii" if ascii_ok else "_span_sc"
        cur = getattr(self, slot, None)
        if cur is None:
            cur = False
            csc = (self._count_scanner_ascii() if ascii_ok
                   else self._count_scanner())
            cd_raw = getattr(csc, "span_cd_raw", None) if csc else None
            if cd_raw is not None and cd_raw.spans_simple:
                cd = cd_raw.minimized()
                if cd.spans_simple:
                    from ..ops.span_scan import SpanScanner
                    cur = SpanScanner(cd)
            setattr(self, slot, cur)
        return cur

    def _span_scanner_for_corpus(self):
        if self._bidi_ascii:
            sc = self._span_scanner(True)
            if sc:
                return sc
        return self._span_scanner(False)

    def _rev_flag_scanner(self, ascii_ok: bool = False):
        """Lazy pre-reset FlagResetScanner over the anchored reverse
        DFA (all-starts: break_at_match=False keeps every viable match
        start flagged); None when out of scope.  ascii_ok selects the
        ASCII-projected tables (exact for all-ASCII corpora; far
        smaller select trees)."""
        kind = "rev_anch_ascii" if ascii_ok else "rev_anch"
        key = (kind + "_pre", 0)
        sc = self._flag_scanner_cache.get(key)
        if sc is None:
            from ..ops.flag_scan import FlagResetScanner
            sc = False
            try:
                self._dense(kind)
                # Moore-minimized tables: anchored reverse DFAs
                # minimize well (version's 64 -> ~30)
                from ..ops.dfa_scan import DeviceDFA
                dd = DeviceDFA.from_dense(
                    self._host_dense[kind].minimized())
            except DFAOverflow:
                dd = None
            if dd is not None:
                hs = dd.host_starts
                # look-free patterns (the only ones routed here) have
                # context-independent start closures; the determinizer
                # may still mint a separate SOT id, so require only the
                # non-SOT contexts to agree and use CTX_OTHER
                if int(hs[1]) == int(hs[2]) == int(hs[3]):
                    try:
                        sc = FlagResetScanner(dd, 3, flag_pre_reset=True)
                    except ValueError:
                        pass
            self._flag_scanner_cache[key] = sc
        return sc or None

    def _sym_tiles_cache_get(self, rsc, n: int, L: int, T: int):
        """Reset-free reverse symbol tiles for the current corpus,
        cached on the engine (strong ref keeps the flipped buffer's id
        stable)."""
        from ..ops.flag_scan import _sym_base_tiles
        from ..utils.corpus_cache import device_corpus_flipped
        devf = device_corpus_flipped(self._bidi_data)
        key = (id(devf), id(rsc), L, T)
        ent = self._sym_tiles_cache.get(key)
        if ent is None or ent[0] is not devf:
            tiles = _sym_base_tiles(devf, rsc.byte_bounds(), L, T // 4)
            ent = (devf, tiles)
            self._sym_tiles_cache[key] = ent
            while len(self._sym_tiles_cache) > 2:
                self._sym_tiles_cache.pop(
                    next(iter(self._sym_tiles_cache)))
        return ent[1]

    def _prefix_family_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """PREFIX_RUN / PREFIX_SET: bidirectional path first; the
        round-4 candidate/reset-scan pipeline as device fallback."""
        r = self._bidi_spans_dev(dev, n, known_cnt=known_cnt, fp=fp)
        if r is not None:
            return r
        if known_cnt is not None or n > self.DEVICE_SPANS_LIMIT:
            return None
        return self._candidate_spans_dev(dev, n)

    def _inner_family_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """INNER: the bidirectional transducer path when the pattern's
        count transducer is spans_simple (email/url: two count-speed
        scans, ~2-3x the candidate/flag-word pipeline at corpus scale);
        the class-run-prefix pipeline otherwise.  Warm cache entries
        disambiguate by shape: the bidi path caches (total, kind)
        tuples, the INNER pipeline caches ints."""
        if known_cnt is None or isinstance(known_cnt, tuple):
            r = self._bidi_spans_dev(dev, n, known_cnt=known_cnt,
                                     fp=fp)
            if r is not None:
                return r
            if known_cnt is not None:
                return None
        return self._inner_spans_dev(dev, n, known_cnt=known_cnt,
                                     fp=fp)

    def _bidi_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """(spans, cnt, ok) via the bidirectional event-stream engine,
        or None (out of scope / failed validation).  Cold path: one
        sync after the forward scan (event count, total, EOI kind);
        warm path: sync-free, ok deferred to the caller."""
        import jax
        from ..dfa.countdfa import EOI_COMPLEX
        from ..ops.bytescan import _bucket
        from ..ops.compact2 import _bucket_up
        from ..ops.span_chain import bidi_assemble, bidi_ends
        if self.longest or self.plan.nullable or litmod.has_looks(
                self.ast):
            return None
        ssc = self._span_scanner_for_corpus()
        if not ssc:
            return None
        rsc = (self._rev_flag_scanner(True) if self._bidi_ascii
               else None) or self._rev_flag_scanner()
        if rsc is None:
            return None
        fw, gw, _nev_d, total_d, kind_d, conv = ssc.scan(dev)
        if known_cnt is None:
            total, kind, convh = (
                int(x) for x in jax.device_get(
                    (total_d, kind_d, conv)))
            if not convh or kind == EOI_COMPLEX:
                return None
        else:
            total, kind = known_cnt
        if total == 0:
            return _empty_spans_dev(), 0, None
        if total > self.MAX_DEVICE_SPANS:
            return None
        capM = _bucket(total + 1, 16)
        nwb = _bucket_up(max(-(-n // 32), 1))
        nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
        from ..ops.flag_scan import (reset_geometry,
                                     scatter_reset_tiles)
        from ..ops.span_chain import _dev_i32
        n_dev = _dev_i32(n)
        ends_c, cntF_d, rq, rw, okA = bidi_ends(
            fw, gw, n_dev, total_d, kind_d, capM, nwb, nwb1)
        # reverse symbol tiles: reset-free 2*cls tiles cached per
        # corpus; per-call reset bits scatter in the TILE domain (a
        # corpus-sized u8 symbol intermediate measured ~7-12 ms per
        # 256 MB per call)
        L, T, _W = reset_geometry(n)
        base_tiles = self._sym_tiles_cache_get(rsc, n, L, T)
        tiles_r = scatter_reset_tiles(base_tiles, rq, L, T // 4)
        # lane-entry hint: the reverse scan's resets are one-per-match
        # (too sparse for the warmup window), so a fresh scan pays a
        # repair rescan; a previous converged scan of the same corpus
        # makes it one-pass (the fixpoint still validates)
        rhint = self._rev_hint_cache.get(fp) if fp is not None else None
        fw_rev, _interf, conv2, rhint_out = rsc.scan_tiles(
            tiles_r, n, entries_hint=rhint)
        if fp is not None:
            self._rev_hint_cache[fp] = rhint_out
        spans, cnt_d, ok = bidi_assemble(ends_c, cntF_d, rw, fw_rev,
                                         n_dev, capM, nwb1)
        ok = ok & okA & conv & conv2
        if known_cnt is None:
            okh = bool(jax.device_get(ok))
            if not okh:
                return None
            # cache only a validated count: the warm path defers its ok
            # flag to the caller and cannot fall back
            if fp is not None:
                self._spans_cnt_cache[fp] = (total, kind)
            return spans, total, None
        return spans, cnt_d, ok

    # interleaved verification handles tens of millions of candidates
    # (contiguous scans, no per-candidate gathers); the cap bounds the
    # compaction buffers
    _DEV_FILTER_LIMIT = 1 << 24

    def _interleaved_ends(self, dev, n, smask, cnt, cap):
        """Verified (starts, ends, kept) for candidate starts, via K
        interleaved reset-scans: subset j resets at every K-th candidate,
        so each candidate's anchored run gets ~K candidate-spacings of
        room — contiguous passes instead of per-candidate window
        GATHERS.  A run still alive at its subset's next
        reset (match longer than the room) trips the interference flag
        and K escalates; exact or None.  Candidates whose run never
        flags are dropped here — Go's walk skips failing candidates, so
        selection over verified pairs alone is exact."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket
        from ..ops.compact import compact_positions
        from ..ops.dfa_scan import ResetScanner
        from ..ops.span_chain import next_value
        iota = jnp.arange(n, dtype=jnp.int32)
        INF = jnp.int32(n)
        try:
            sc = ResetScanner(self._dense(self._verify_kind()))
        except ValueError:
            return None  # > 32 byte-segments: aux packing gate
        rank = jnp.cumsum(smask.astype(jnp.int32))  # 1-based at cands
        # density-adaptive interleaving: each candidate's run gets
        # ~K * spacing bytes of room; sparse candidate sets need less
        spacing = n // max(cnt, 1)
        ladder = (2, 4, 16) if spacing >= 48 else (4, 16)
        for K in ladder:
            parts = []
            ok = True
            scap = _bucket(-(-cnt // K), 16)
            for j in range(K):
                sub = smask & ((rank - 1) % K == j)
                flags, exits, conv, interf, (L, T) = sc.scan_device(
                    dev, sub)
                convh, interfh = (bool(x) for x in
                                  jax.device_get((conv, interf)))
                if not convh:
                    return None
                if interfh:
                    ok = False
                    break
                flag, eoi_flag = self._flags_with_eoi(
                    flags, n, not litmod.has_looks(self.ast))
                if flag is None:
                    return None  # EOI undecidable in-scan: host path
                ext = jnp.concatenate([sub, jnp.zeros(1, dtype=bool)])
                iota1 = jnp.arange(n + 1, dtype=jnp.int32)
                INF1 = jnp.int32(n + 1)
                flag1 = jnp.concatenate(
                    [flag, jnp.full(1, eoi_flag, bool)])
                nr_ex = jnp.concatenate(
                    [next_value(ext, iota1, INF1)[1:],
                     jnp.full(1, n + 1, jnp.int32)])
                nf_ex = jnp.concatenate(
                    [next_value(flag1, iota1, INF1)[1:],
                     jnp.full(1, n + 1, jnp.int32)])
                endm = flag1 & (nf_ex >= nr_ex)  # last flag per interval
                has = ext & (nf_ex < nr_ex)      # verified candidates
                s_j, cs = compact_positions(has, scap)
                e_j, ce = compact_positions(endm, scap)
                ok_j, csn = (bool(x) if i == 0 else int(x) for i, x in
                             enumerate(jax.device_get(
                                 ((cs == ce) & (cs <= scap), cs))))
                if not ok_j:  # pragma: no cover - alignment broken
                    return None
                lv = jnp.arange(scap, dtype=jnp.int32) < csn
                parts.append((jnp.where(lv, s_j, INF + 1),
                              jnp.where(lv, e_j, -1)))
            if ok:
                break
        else:
            return None  # interference at K=16: host fallback
        alls = jnp.concatenate([s for s, e in parts])
        alle = jnp.concatenate([e for s, e in parts])
        order_s, order_e = jax.lax.sort((alls, alle), num_keys=1)
        kept = int(jax.device_get(
            (order_s <= INF).sum(dtype=jnp.int32)))
        return order_s, order_e, kept

    @staticmethod
    def _flags_with_eoi(flags, n, lookfree: bool):
        """(flag[:n], flag_at_n) from a padded scan's flag matrix.  For
        look-free patterns, accepting is a pure state property, so the
        scan's flag at offset n (computed against the first zero pad
        byte) equals the EOI acceptance — ends-at-n come out of the scan
        itself, no host tail replay.  (None, None) when not decidable
        in-scan (looks, or no pad region)."""
        flat = flags.reshape(-1)
        if lookfree and int(flat.shape[0]) > n:
            return flat[:n], flat[n]
        return None, None

    def _candidate_spans_dev(self, dev, n):
        """PREFIX_RUN / PREFIX_SET: device candidate starts -> device
        window verification -> device filter + non-overlap check."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import (_bucket, _memmem_mask, mask_count,
                                    _multi_literal_scan)
        from ..ops.compact import compact_positions
        from ..ops.dfa_scan import WindowScanner
        if self._pf_retired:
            return None
        if self.plan.strategy == Strategy.PREFIX_RUN:
            smask, cnt_dev = self._prefix_run_candidates_mask(dev)
            cnt = int(jax.device_get(cnt_dev))
        else:
            lits = tuple(tuple(l) for l in self.plan.prefix_lits)
            smask = None
            for lit in lits:
                m = _memmem_mask(dev, lit)
                smask = m if smask is None else (smask | m)
            cnt = int(jax.device_get(mask_count(smask)))
        return self._spans_from_candidate_mask(dev, n, smask, cnt)

    def _bitset_nfa_spans_dev(self, dev, n, known_cnt=None, fp=None):
        """BITSET_NFA (DFA-overflow) device extraction: match starts
        from the reverse bitset-NFA scan over the flipped corpus (a
        reversed end at boundary j is a forward start at n - j), then
        the shared interleaved-reset-scan verification + device Go
        selection.  The anchored verification DFA is usually far
        smaller than the overflowing unanchored one.  Reference: the
        same bidirectional structure, meta/findall.go:216-239."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import mask_count
        from ..utils.corpus_cache import device_corpus_flipped
        sc = self._bitset_scanner("rev")
        if not sc:
            return None
        fdev = device_corpus_flipped(self._bidi_data)
        fr, conv = sc.flags(fdev)
        # flags[p] = a reversed match ends at boundary p+1 (match
        # delay), i.e. a forward start at n - (p+1): flip flags[:n]
        smask = jnp.flip(fr[:n])
        cnt, convh = (int(x) for x in
                      jax.device_get((mask_count(smask), conv)))
        if not convh:
            return None
        return self._spans_from_candidate_mask(dev, n, smask, cnt)

    def _spans_from_candidate_mask(self, dev, n, smask, cnt):
        """Shared candidate-mask tail: interleaved reset-scan
        verification, device Go-selection fixed point, compaction."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket
        if cnt == 0:
            return _empty_spans_dev(), 0
        if cnt > self._DEV_FILTER_LIMIT:
            return None
        cap = _bucket(cnt, 16)
        r = self._interleaved_ends(dev, n, smask, cnt, cap)
        if r is None:
            return None
        fs, fe, kept = r
        self._note_prefilter_counts(kept, cnt)
        if kept == 0:
            return _empty_spans_dev(), 0
        kcap = int(fs.shape[0])
        klive = jnp.arange(kcap, dtype=jnp.int32) < kept
        fs = jnp.where(klive, fs, jnp.int32(2**31 - 1))
        fe = jnp.where(klive, fe, jnp.int32(-1))
        if not bool(jax.device_get(jnp.all(jnp.where(klive, fs < fe,
                                                     True)))):
            return None  # pragma: no cover - verifier contract broken
        nxt = jnp.concatenate([fs[1:], jnp.full(1, 2**31 - 1, jnp.int32)])
        overlap = jnp.any(jnp.where(
            jnp.arange(kcap, dtype=jnp.int32) < kept - 1, fe > nxt, False))
        if bool(jax.device_get(overlap)):
            # overlapping verified matches (version-style chains): exact
            # Go selection via the device fixed point
            from ..ops.span_kernels import go_select_device
            selm, ok = go_select_device(fs, fe, kept, kcap)
            if not ok:
                return None  # not converged: host go_select walk
            nsel = int(jax.device_get((selm & klive)
                                      .sum(dtype=jnp.int32)))
            if nsel == 0:
                return _empty_spans_dev(), 0
            scap = _bucket(nsel, 16)
            from ..ops.bytescan import _mask_nonzero
            idx = jnp.minimum(_mask_nonzero(selm & klive, scap), kcap - 1)
            fs = jnp.take(fs, idx)
            fe = jnp.take(fe, idx)
            slive = jnp.arange(scap, dtype=jnp.int32) < nsel
            fe = jnp.where(slive, fe, fs)
            return jnp.stack([fs, fe], axis=1), nsel
        fe = jnp.where(klive, fe, fs)
        return jnp.stack([fs, fe], axis=1), kept

    def _note_prefilter_counts(self, hits: int, seen: int) -> None:
        """Counter-only twin of _note_prefilter (device paths sync the
        counts, not the keep mask)."""
        self._pf_hits += hits
        self._pf_seen += seen
        if self.stats is not None:
            self.stats.prefilter_hits += hits
            self.stats.prefilter_misses += seen - hits
        if (self._pf_seen >= self.PF_MIN_SAMPLES
                and self._pf_hits < self._pf_seen * self.PF_MIN_RATIO):
            from .config import debug
            debug(1, f"prefilter retired: {self._pf_hits}/{self._pf_seen} "
                     "confirm ratio below threshold")
            self._pf_retired = True

    def _end_anchored_spans(self, data: np.ndarray, n: int) -> np.ndarray:
        """End-anchored (`$`/`\\z`) patterns have at most one match, ending
        exactly at n: a single backward anchored-reverse scan finds its
        start (ReverseAnchoredSearcher, meta/reverse_anchored.go:98) in
        O(match length) — no forward corpus scan at all."""
        from ..dfa.search import find_rev_start
        self._dense("rev_anch")
        rev = self._host_dense["rev_anch"]
        s = find_rev_start(rev, data, 0, n)
        if s < 0:
            return np.empty((0, 2), dtype=np.int64)
        return np.array([[s, n]], dtype=np.int64)

    @_device_serial
    def is_match(self, data: np.ndarray):
        """True/False, or None when the device path is out of scope
        (caller falls back to the host engine)."""
        import jax
        n = len(data)
        strat = self.plan.strategy
        if strat in (Strategy.NULLABLE_CORE, Strategy.ALL_EMPTY):
            # decompose() guarantees an unconditional empty match
            return True
        if strat == Strategy.END_ANCHORED:
            return len(self._end_anchored_spans(data, n)) > 0
        if strat == Strategy.BITSET_NFA:
            from ..utils.corpus_cache import device_corpus
            r = self._bitset_is_match(device_corpus(data), n)
            if r is not None:
                return r
            sp = self._bitset_spans(device_corpus(data), data, n, 1)
            return None if sp is None else len(sp) > 0
        if strat != Strategy.FULL_SCAN:
            m = self.find_first(data)
            return None if m is FALLBACK else m is not None
        from ..dfa.dense import CTX_SOT
        from ..ops.dfa_scan import ChunkScanner, flags_count_upto
        from ..utils.corpus_cache import device_corpus
        dev = device_corpus(data)
        fwd = self._dense("fwd_all")
        self.served_by = "dfa_scan"
        sc = ChunkScanner(fwd)
        flags, exits, conv, (L, T) = sc.scan_device(dev)
        if not bool(jax.device_get(conv)):
            hflags, _ = sc._host_scan(dev, None)
            return bool(hflags.any())
        if int(jax.device_get(flags_count_upto(flags, n))) > 0:
            return True
        exit_n = sc._exit_at_n(dev, exits, L, T, n)
        return bool(fwd.host_eoi[exit_n, CTX_SOT])

    def _make_count_scanner(self, ascii_only: bool):
        """Build a CountScanner over the FindAll-count transducer, or
        False when out of scope.  ascii_only builds the ASCII-projected
        tables (the reference's dot-optimized ASCII NFA,
        meta/compile.go:386-430): exact whenever the corpus has no byte
        >= 0x80, and typically 3-6 byte classes instead of the 15-25 the
        UTF-8 rune automaton needs."""
        from ..dfa.countdfa import (build_count_dfa,
                                    build_count_dfa_nullable)
        from ..ops.count_scan import CountScanner
        try:
            nfa = compile_nfa(self.parsed, with_captures=False,
                              ascii_only=ascii_only)
            if self.plan.nullable:
                from ..dfa.determinize import determinize_py
                u = determinize_py(nfa, anchored=False,
                                   break_at_match=True, track_empty=True)
                cd = build_count_dfa_nullable(u)
            else:
                u = determinize(nfa, anchored=False, break_at_match=True)
                cd = build_count_dfa(u)
        except DFAOverflow:
            return False
        if cd is None:
            return False
        cd_raw = cd
        cd = cd.without_spans().minimized()
        sc = CountScanner(cd)
        # unminimized span-event transducer for the bidirectional span
        # path (ops/span_scan.py); minimized span-aware on first use
        sc.span_cd_raw = cd_raw
        return sc

    def _count_scanner_ascii(self):
        """Lazy ASCII-projected CountScanner; only valid for corpora
        where every byte < 0x80."""
        if self._count_sc_ascii is None:
            self._count_sc_ascii = False
            if not self.longest:
                self._count_sc_ascii = self._make_count_scanner(
                    ascii_only=True)
        return self._count_sc_ascii

    def _count_scanner(self):
        """Lazy CountScanner over the FindAll-count transducer
        (dfa/countdfa.py; the nullable variant with Go empty-match rules
        for nullable patterns); False when the pattern is out of scope
        (POSIX-longest, chain/state overflow)."""
        if self._count_sc is None:
            self._count_sc = False
            if not self.longest:
                self._count_sc = self._make_count_scanner(ascii_only=False)
        return self._count_sc

    def _count_scanner_for(self, data: np.ndarray):
        """Best applicable count scanner for this corpus: the ASCII
        -projected tables when the corpus is ASCII (simd.IsASCII runtime
        switch, meta/ismatch.go:217 analogue), else the full rune
        tables."""
        if corpus_is_ascii(data):
            sc = self._count_scanner_ascii()
            if sc:
                return sc
        return self._count_scanner()

    def _sharded_counter(self, sc):
        """Multi-device sequence-parallel counter over count scanner
        `sc` (parallel/sharded_count.py): each device scans its shard
        with the one-card transducer and shards stitch exactly.  False
        when only one device is visible."""
        import jax
        if not sc or len(jax.devices()) <= 1:
            return False
        shc = self._sharded_sc.get(id(sc))
        if shc is None:
            from ..parallel.shard import default_mesh
            from ..parallel.sharded_count import ShardedGoCount
            shc = ShardedGoCount(sc, default_mesh())
            self._sharded_sc[id(sc)] = shc
        return shc

    def _scanner_count(self, sc, data: np.ndarray) -> Optional[int]:
        """Count through scanner `sc`: sharded over the mesh when more
        than one device is visible, else on the one device.  None when
        boundary repair did not converge (the caller falls back)."""
        shc = self._sharded_counter(sc)
        if shc:
            self.served_by = "count_transducer_sharded"
            return shc.count(data)
        from ..utils.corpus_cache import device_corpus
        self.served_by = "count_transducer"
        return sc.count(device_corpus(data))

    @_device_serial
    def nullable_count(self, data: np.ndarray) -> Optional[int]:
        """Device count for NULLABLE patterns via the empty-match-aware
        count transducer (dfa/countdfa.py:build_count_dfa_nullable), or
        None when out of scope.  Gate: the transducer advances one BYTE
        after an empty match where Go advances one RUNE — exact unless
        the corpus contains a valid multi-byte UTF-8 lead (0xC2-0xF4)."""
        if len(data) == 0:
            return None
        sc = self._count_scanner_for(data)
        if not sc or not getattr(sc.cd, "requires_width1", False):
            return None
        if not corpus_is_ascii(data):
            mx = int(data.max())
            if mx >= 0xC2 and bool(((data >= 0xC2) & (data <= 0xF4)).any()):
                return None
        return self._scanner_count(sc, data)

    @_device_serial
    def count(self, data: np.ndarray) -> int:
        """Match count with device-side fast paths (Count,
        meta/findall.go:297 analogue): most strategies reduce to a single
        launch + one scalar sync without materializing spans.  With more
        than one device visible, the count transducer shards the corpus
        over the mesh (SURVEY.md §2.9 sequence parallelism).  Records
        the path that answered in `served_by`."""
        import jax
        from ..utils.corpus_cache import device_corpus
        strat = self.plan.strategy
        self.served_by = None
        if strat == Strategy.END_ANCHORED:
            self.served_by = "end_anchored"
            return len(self._end_anchored_spans(data, len(data)))
        if strat in (Strategy.NULLABLE_CORE, Strategy.ALL_EMPTY):
            # the nullable count transducer (Go empty-match rules baked
            # in) is a single scan; the span path is the UTF-8-exact
            # fallback.  NOTE: the generic scanners below must not run
            # for nullable plans — their transducer advances one byte
            # after an empty match (requires_width1) without the UTF-8
            # corpus gate nullable_count applies.
            c = self.nullable_count(data)
            if c is not None:
                return c
            sp = self.find_all_spans(data)
            return None if sp is None else len(sp)
        sc = self._count_scanner_for(data)
        if len(jax.devices()) > 1 and sc:
            c = self._scanner_count(sc, data)
            if c is not None:
                return c
        dev = device_corpus(data)
        if strat == Strategy.CHARCLASS:
            from ..ops.bytescan import class_run_count
            cc = self.plan.charclass
            # plus (whole-run) form counts one match per run of len >= min,
            # exactly the k == -1 reduction
            kmax = -1 if cc.plus else cc.max
            self.served_by = "class_run"
            return class_run_count(dev, np.array(cc.table, dtype=bool),
                                   cc.min, kmax)
        if strat == Strategy.LITERAL:
            from ..ops.bytescan import literal_self_overlaps, memmem_count
            lit = self.plan.literals[0]
            if not literal_self_overlaps(lit):
                self.served_by = "memmem"
                return memmem_count(dev, lit)
        if strat == Strategy.MULTI_LITERAL:
            from ..ops.bytescan import _multi_count_kernel
            lits = tuple(tuple(l) for l in self.plan.literals)
            cnt, overlap = jax.device_get(_multi_count_kernel(dev, lits))
            if not bool(overlap):
                self.served_by = "multi_literal"
                return int(cnt)
        # sparse-candidate strategies: when the inner/prefix literal is
        # rare, the candidate pipeline beats a full-corpus DFA scan.  The
        # threshold is deliberately tight (one candidate per 4 KB): the
        # span pipeline pays per-candidate window scans plus host span
        # selection, while the CountDFA scan below runs at full DFA
        # bandwidth regardless of density (the prefilter-effectiveness
        # rule of prefilter/tracker.go:37, applied ahead of time).
        if strat in (Strategy.INNER, Strategy.PREFIX_SET):
            n = len(data)
            cnt = self._candidate_count(dev)
            if cnt == 0:
                self.served_by = "candidates"
                return 0
            if cnt <= max(n >> 12, 1024) or not sc:
                if cnt <= max(n // 64, 1024):
                    sp = self.find_all_spans(data)
                    self.served_by = "candidates+" + str(self.served_by)
                    return len(sp)
        # universal single-launch path: the count transducer scan
        if sc:
            c = self._scanner_count(sc, data)
            if c is not None:
                return c
        if strat == Strategy.PREFIX_RUN:
            c = self._prefix_run_count_device(dev, data, len(data))
            if c is not None:
                self.served_by = "prefix_run"
                return c
        if strat == Strategy.LINE_SHAPE:
            c = self._line_shape_count_device(dev, len(data))
            if c is not None:
                self.served_by = "line_shape"
                return c
        sp = self.find_all_spans(data)
        return None if sp is None else len(sp)

    # -- single-match (Find / FindIndex, meta/find.go:29 analogue) --------
    @_device_serial
    def find_first(self, data: np.ndarray):
        """Leftmost-first span (start, end), None (no match), or the
        FALLBACK sentinel (host fallback — device scan out of scope or
        non-convergent).  Strategy shortcuts for the literal/class
        families; the general path is the bidirectional two-pass core
        (dfa/search.py:83 find_span) run as a chunked break-at-match
        forward scan with geometric prefix escalation + a reverse
        anchored scan from the found end."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import (_class_mask_from_table, _memmem_mask,
                                    _multi_literal_scan, first_set_index)
        from ..utils.corpus_cache import device_corpus
        n = len(data)
        if n == 0:
            return None
        dev = device_corpus(data)
        strat = self.plan.strategy
        self.served_by = "bytescan"
        if strat == Strategy.LITERAL:
            # chunked: first-match should touch O(prefix) HBM, not build
            # a whole-corpus match mask for a hit at offset 100
            lit = self.plan.literals[0]
            k = len(lit)
            CH = 1 << 24
            for off in range(0, n, CH):
                end = min(n, off + CH)
                sl = dev[off:min(n, end + k - 1)]
                p = first_set_index(_memmem_mask(sl, tuple(lit)))
                if p < end - off:
                    return (off + p, off + p + k)
            return None
        if strat == Strategy.MULTI_LITERAL:
            lits = tuple(tuple(l) for l in self.plan.literals)
            # chunked: find_first should touch O(prefix), not build
            # priority/length maps for the whole corpus
            maxlen = max(len(l) for l in self.plan.literals)
            CH = 1 << 24
            for off in range(0, n, CH):
                end = min(n, off + CH)
                sl = dev[off:min(n, end + maxlen - 1)]
                best, blen = _multi_literal_scan(sl, lits)
                p = first_set_index(best >= 0)
                if p < end - off:
                    k = int(jax.device_get(blen[p]))
                    return (off + p, off + p + k)
            return None
        if strat == Strategy.CHARCLASS:
            return self._charclass_first(dev, n)
        if strat == Strategy.END_ANCHORED:
            sp = self._end_anchored_spans(data, n)
            return None if len(sp) == 0 else (int(sp[0, 0]), int(sp[0, 1]))
        if strat == Strategy.BITSET_NFA:
            sp = self._bitset_spans(dev, data, n, 1)
            if sp is None:
                return FALLBACK  # host fallback
            return None if len(sp) == 0 else (int(sp[0, 0]), int(sp[0, 1]))
        if strat in (Strategy.NULLABLE_CORE, Strategy.ALL_EMPTY):
            # single leftmost match is O(match length) on host
            return FALLBACK
        self.served_by = "dfa_scan"
        return self._find_first_dfa(dev, data, n)

    def _charclass_first(self, dev, n) -> Optional[Tuple[int, int]]:
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _class_mask_from_table, first_run_geq
        cc = self.plan.charclass
        mask = _class_mask_from_table(dev, np.array(cc.table, dtype=bool))
        s, L = jax.device_get(first_run_geq(mask, cc.min))
        s, L = int(s), int(L)
        if s >= n:
            return None
        m, k = cc.min, cc.max
        if cc.plus:
            r = L % k
            return (s, s + L - (r if r < m else 0))
        if k == -1:
            return (s, s + L)
        return (s, s + min(k, L))

    def _find_first_dfa(self, dev, data, n) -> Optional[Tuple[int, int]]:
        """Two-pass bidirectional find: break-at-match forward chunk scan
        (its last flag before automaton death is the leftmost-first end)
        + anchored reverse scan for the earliest start."""
        import jax
        import jax.numpy as jnp
        from ..dfa.dense import CTX_SOT, DEAD
        from ..ops.dfa_scan import ChunkScanner, flags_last
        fwd = self._dense("fwd_break")
        sc = ChunkScanner(fwd, dead_stops=True)
        c = min(n, 1 << 22)
        e = -1
        while True:
            flags, exits, conv, (L, T) = sc.scan_device(dev[:c])
            if not bool(jax.device_get(conv)):
                return FALLBACK  # caller falls back to host
            e = int(jax.device_get(flags_last(flags, c)))
            exit_c = sc._exit_at_n(dev[:c], exits, L, T, c)
            dead = exit_c == DEAD
            if dead:
                break
            if c == n:
                if fwd.host_eoi[exit_c, CTX_SOT]:
                    e = n
                break
            c = min(n, c * 8)
        if e < 0:
            return None
        starts = self._rev_start_flags(dev, data, n, np.array([e]),
                                       kind="rev_anch")
        if starts is None:
            return FALLBACK  # caller falls back to host
        if len(starts) == 0:  # pragma: no cover - fwd/rev disagree
            return None
        return (int(starts.min()), e)

    def _candidate_count(self, dev) -> int:
        """Device count of candidate positions for the INNER / PREFIX_SET
        prefilter (one launch, one scalar sync) — the runtime density gate
        (prefilter/tracker.go:37 analogue, resolved per corpus)."""
        import jax
        from ..ops.bytescan import (_MULTI_SPAN_CHUNK, _memmem_mask,
                                    _multi_literal_scan, mask_count)
        if self.plan.strategy == Strategy.INNER:
            sp = self.plan.split
            if len(sp.lits) == 1:
                mask = _memmem_mask(dev, tuple(sp.lit))
                return int(jax.device_get(mask_count(mask)))
            lits = tuple(tuple(l) for l in sp.lits)
        else:
            lits = tuple(tuple(l) for l in self.plan.prefix_lits)
        # chunked: the priority map is int32 per position — bound the
        # transient on GB corpora
        n = int(dev.shape[0])
        maxlen = max(len(l) for l in lits)
        total = 0
        for off in range(0, n, _MULTI_SPAN_CHUNK):
            end = min(n, off + _MULTI_SPAN_CHUNK)
            sl = dev[off:min(n, end + maxlen - 1)]
            best, _ = _multi_literal_scan(sl, lits)
            limit = end - off
            total += int(jax.device_get(mask_count(
                (best >= 0)[:limit])))
        return total

    # .. prefix-run (leading [class]+) .................................
    def _prefix_run_table(self) -> np.ndarray:
        return np.array(self.plan.prefix_run.table, dtype=bool)

    def _prefix_run_candidates_mask(self, dev):
        """Device mask + count of run-start candidates, sharpened by the
        offset-byte-range sieve (Teddy/digit prefilter analogue); one
        fused launch."""
        global _prefix_run_cand_kernel
        from ..ops.bytescan import table_to_ranges
        if _prefix_run_cand_kernel is None:
            _prefix_run_cand_kernel = _prefix_run_cand_kernel_factory()
        cls_ranges = table_to_ranges(self._prefix_run_table())
        sieve = tuple(tuple(r) for r in self._sieve_ranges())
        smask, cnt = _prefix_run_cand_kernel(dev, cls_ranges, sieve)
        return smask, cnt

    def _prefix_run_spans(self, dev, data, n, limit) -> np.ndarray:
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, _mask_nonzero
        from ..ops.dfa_scan import WindowScanner
        table = self._prefix_run_table()
        smask, cnt_dev = self._prefix_run_candidates_mask(dev)
        cnt = int(jax.device_get(cnt_dev))
        if cnt == 0:
            cand = np.empty(0, dtype=np.int64)
        else:
            cap = _bucket(cnt, 16)
            cand = np.asarray(jax.device_get(
                _mask_nonzero(smask, cap)))[:cnt].astype(np.int64)
        if len(cand) == 0:
            return np.empty((0, 2), dtype=np.int64)
        if len(cand) > max(n // 6, 1024):
            return self._full_scan_spans(dev, data, n, limit)
        ws = WindowScanner(self._dense(self._verify_kind()), init_window=32)
        # fixpoint expansion: a match end landing mid-run is itself a
        # possible restart start (leading [c]+ makes true starts closed
        # leftward within a run; see PrefixRunShape)
        for _ in range(16):
            ends = ws.ends_for_starts(dev, cand)
            valid = ends >= 0
            e = ends[valid]
            e_in = e[(e > 0) & (e < n)]
            mid = e_in[table[data[e_in]] & table[data[e_in - 1]]]
            new = np.setdiff1d(mid, cand)
            if len(new) == 0:
                break
            cand = np.union1d(cand, new)
        else:
            return self._full_scan_spans(dev, data, n, limit)
        return go_select(cand[valid], ends[valid], n, data, limit)

    def _prefix_run_count_device(self, dev, data, n):
        """Device-side bulk count for PREFIX_RUN: returns None when the
        bulk conditions (no overlaps, no mid-run restarts) fail."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, _mask_nonzero
        from ..ops.dfa_scan import WindowScanner
        table = self._prefix_run_table()
        smask, cnt_dev = self._prefix_run_candidates_mask(dev)
        cnt = int(jax.device_get(cnt_dev))
        if cnt == 0:
            return 0
        if cnt > max(n // 6, 1024):
            return None
        cap = _bucket(cnt)
        starts_dev = jnp.minimum(_mask_nonzero(smask, cap),
                                 n).astype(jnp.int32)
        ws = WindowScanner(self._dense(self._verify_kind()), init_window=32)
        ends_dev = ws.ends_for_starts_device(dev, starts_dev, cnt)
        tbl_dev = jnp.asarray(table)
        count, overlap, pending = jax.device_get(
            _bulk_count_kernel(starts_dev, ends_dev, dev, tbl_dev,
                               jnp.int32(n)))
        if bool(overlap) or bool(pending):
            return None
        return int(count)

    # -- strategy executors ---------------------------------------------
    def _charclass_spans(self, dev, n, limit) -> np.ndarray:
        import jax
        from ..ops.bytescan import (_bucket, _class_mask_from_table,
                                    _mask_nonzero, _run_masks, mask_count)
        cc = self.plan.charclass
        mask = _class_mask_from_table(dev, np.array(cc.table, dtype=bool))
        smask, emask = _run_masks(mask)
        cnt = int(jax.device_get(mask_count(smask)))
        if cnt == 0:
            return np.empty((0, 2), dtype=np.int64)
        # with min<=1 every run yields >=1 match, so a find-all limit
        # bounds the extraction (a 1.5 GB corpus can hold 300M+ runs;
        # extracting them all for find_all(n=10) would be absurd)
        take = cnt if (limit < 0 or cc.min > 1) else min(cnt, limit)
        cap = _bucket(take, 16)
        starts = np.asarray(jax.device_get(
            _mask_nonzero(smask, cap)))[:take].astype(np.int64)
        ends = np.asarray(jax.device_get(
            _mask_nonzero(emask, cap)))[:take].astype(np.int64) + 1
        m, k = cc.min, cc.max
        if cc.plus:
            # ([c]{m,k})+ whole-run form: one match per run of length >= m,
            # greedy k-chunks + remainder iff >= m (CharClassShape.plus)
            L = ends - starts
            keep = L >= m
            L = L[keep]
            r = L % k
            M = L - np.where(r < m, r, 0)
            spans = np.stack([starts[keep], starts[keep] + M], axis=1)
        elif m == 1 and k == -1:
            spans = np.stack([starts, ends], axis=1)
        else:
            out: List[Tuple[int, int]] = []
            for s, e in zip(starts, ends):
                run = e - s
                p = s
                while run >= m:
                    take = run if k == -1 else min(k, run)
                    out.append((p, p + take))
                    p += take
                    run -= take
                    if limit >= 0 and len(out) >= limit:
                        break
            spans = np.array(out, dtype=np.int64).reshape(-1, 2)
        if limit >= 0:
            spans = spans[:limit]
        return spans.astype(np.int64)

    def _literal_spans(self, dev, data, n, limit) -> np.ndarray:
        from ..ops.bytescan import memmem
        lit = self.plan.literals[0]
        k = len(lit)
        pos = memmem(dev, lit)
        ends = pos + k
        return go_select(pos, ends, n, data, limit)

    def _multi_literal_spans(self, dev, data, n, limit) -> np.ndarray:
        from ..ops.bytescan import multi_literal_hits
        pos, idx, lens = multi_literal_hits(dev, self.plan.literals)
        return go_select(pos, pos + lens, n, data, limit)

    # .. line shapes .....................................................
    def _line_shape_parts(self, sp):
        a_univ = sp.prefix_universal
        b_empty = sp.suffix_ast.op == Op.EMPTY
        b_univ = sp.suffix_universal
        a_is_empty = litmod.exact_literals(sp.prefix_ast) == [sp.lit] \
            and not sp.line_anchored
        return a_univ, b_empty, b_univ, a_is_empty

    def _line_valid_mask(self, dev, n):
        """[n] bool device mask: candidate positions that are valid within
        their line (lit fits before line end; line-anchored prefix checks).
        Returns (valid_mask, prev_nl, next_nl)."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _memmem_mask, line_bound_arrays
        sp = self.plan.split
        lit, k = sp.lit, len(sp.lit)
        cand_mask = _memmem_mask(dev, tuple(lit))
        prev_nl, next_nl = line_bound_arrays(dev)
        idxs = jnp.arange(n, dtype=jnp.int32)
        valid = cand_mask & (idxs + k <= next_nl)
        if sp.line_anchored:
            P = sp.prefix_literal
            pl = len(P)
            if pl:
                prefix_at = _memmem_mask(dev, tuple(P))
                is_ls = (idxs == 0) | (dev[jnp.maximum(idxs - 1, 0)]
                                       == np.uint8(10))
                # a position's line is "good" iff its line start carries the
                # required prefix: latest good line start == this line start
                lg = jax.lax.cummax(
                    jnp.where(is_ls & prefix_at, idxs, -1))
                line_good = lg == (prev_nl + 1)
                valid = valid & line_good & (idxs >= prev_nl + 1 + pl)
        return valid, prev_nl, next_nl

    def _line_candidates(self, dev, data, n):
        """Valid line-shape candidates with their line bounds, computed
        per-candidate: the candidate/newline masks compact through the
        bounded two-level scheme and line bounds come from a searchsorted
        over newline positions — O(corpus) bool + O(candidates) int32,
        instead of the two full-corpus int32 cummax arrays the old
        pipeline materialized (VERDICT r2 weak item 5).  Returns
        (cand, line_start, line_end) host int64 arrays (validity and
        (?m)^prefix anchoring already applied), or (None, None, None)
        when the candidate set is too dense (full-scan fallback)."""
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import (_bucket, _mask_nonzero, _memmem_mask,
                                    _newline_mask, mask_count)
        sp = self.plan.split
        lit, k = sp.lit, len(sp.lit)
        cand_mask = _memmem_mask(dev, tuple(lit))
        cnt = int(jax.device_get(mask_count(cand_mask)))
        empty = np.empty(0, dtype=np.int64)
        if cnt == 0:
            return empty, empty, empty
        if cnt > MAX_CANDIDATES:
            return None, None, None
        cap = _bucket(cnt, 16)
        cand_dev = _mask_nonzero(cand_mask, cap)        # sentinel n
        del cand_mask  # free the corpus-sized mask before the next one
        nl_mask = _newline_mask(dev)
        nl_cnt = int(jax.device_get(mask_count(nl_mask)))
        nlcap = _bucket(max(nl_cnt, 1), 16)
        nl_dev = _mask_nonzero(nl_mask, nlcap)          # sorted, tail n
        del nl_mask

        P_lit = tuple(sp.prefix_literal) if sp.line_anchored else ()
        valid, ls_d, le_d = _line_cand_bounds(
            dev, cand_dev, nl_dev, jnp.int32(n), k=k, prefix=P_lit)
        valid = np.asarray(jax.device_get(valid))[:cnt]
        ls = np.asarray(jax.device_get(ls_d))[:cnt].astype(np.int64)
        le = np.asarray(jax.device_get(le_d))[:cnt].astype(np.int64)
        cand = np.asarray(jax.device_get(cand_dev))[:cnt].astype(np.int64)
        return cand[valid], ls[valid], le[valid]

    def _line_shape_count_device(self, dev, n) -> Optional[int]:
        """Device-only line-shape count: one match per candidate line,
        one fused launch."""
        import jax
        global _line_count_kernel
        sp = self.plan.split
        a_univ, b_empty, b_univ, a_is_empty = self._line_shape_parts(sp)
        if a_univ == UNIV_ANY or b_univ == UNIV_ANY:
            return None  # single-match shapes: spans path is trivial
        if _line_count_kernel is None:
            _line_count_kernel = _line_count_kernel_factory()
        return int(jax.device_get(_line_count_kernel(
            dev, tuple(sp.lit),
            tuple(sp.prefix_literal) if sp.line_anchored else (),
            sp.line_anchored)))

    def _line_shape_spans(self, dev, data, n, limit) -> np.ndarray:
        import jax
        import jax.numpy as jnp
        from ..ops.bytescan import _bucket, _mask_nonzero, mask_count, memmem
        sp = self.plan.split
        lit, k = sp.lit, len(sp.lit)
        a_univ, b_empty, b_univ, a_is_empty = self._line_shape_parts(sp)

        if a_univ == UNIV_ANY or b_univ == UNIV_ANY:
            cand = memmem(dev, lit)
            if len(cand) == 0:
                return np.empty((0, 2), dtype=np.int64)
            return self._line_shape_any(data, n, cand, k, a_univ, b_univ,
                                        b_empty, a_is_empty, limit)

        cand, ls, le = self._line_candidates(dev, data, n)
        if cand is None:
            return self._full_scan_spans(dev, data, n, limit)
        if len(cand) == 0:
            return np.empty((0, 2), dtype=np.int64)

        # group by line (cand sorted ascending => ls non-decreasing)
        uniq_ls, first_idx = np.unique(ls, return_index=True)
        last_idx = np.concatenate([first_idx[1:] - 1, [len(cand) - 1]])
        line_le = le[first_idx]

        if a_is_empty:
            # L .*   : (first candidate per line, line end)
            spans = np.stack([cand[first_idx], line_le], axis=1)
        elif b_empty:
            # (.*|^P.*) L : (line start, last candidate + k)
            spans = np.stack([uniq_ls, cand[last_idx] + k], axis=1)
        else:
            # (.*|^P.*) L .* : (line start, line end)
            spans = np.stack([uniq_ls, line_le], axis=1)
        if limit >= 0:
            spans = spans[:limit]
        return spans.astype(np.int64)

    def _line_shape_any(self, data, n, cand, k, a_univ, b_univ, b_empty,
                        a_is_empty, limit) -> np.ndarray:
        """(?s) universal variants: at most one match."""
        from ..ops.bytescan import line_ends_for, newline_positions
        from ..utils.corpus_cache import device_corpus
        nl = newline_positions(device_corpus(data))
        if a_univ == UNIV_ANY:
            start = 0
            if b_univ == UNIV_ANY:
                end = n
            elif b_univ == UNIV_LINE:
                end = int(line_ends_for(cand[-1:], nl, n)[0])
            else:
                end = int(cand[-1]) + k
        else:
            # B is (?s).* universal; start side line-bounded or literal
            end = n
            if a_is_empty:
                start = int(cand[0])
            elif a_univ == UNIV_LINE:
                from ..ops.bytescan import line_starts_for
                start = int(line_starts_for(cand[:1], nl)[0])
            else:
                from ..utils.corpus_cache import device_corpus
                return self._inner_spans(device_corpus(data), data, n,
                                         limit)
        return np.array([[start, end]], dtype=np.int64)

    # .. inner-literal general ...........................................
    def _rev_start_flags(self, dev, data, n, cand_end: np.ndarray,
                         kind: str = "rev_prefix") -> np.ndarray:
        """All match-start positions discovered by reverse scans of the
        `kind` DFA anchored at each candidate end.  Returns sorted unique
        start offsets."""
        import jax
        import jax.numpy as jnp
        from ..ops.dfa_scan import _bucket, _window_scan_flags
        from ..utils.corpus_cache import device_corpus_flipped
        rp = self._dense(kind)
        fdev = device_corpus_flipped(data)
        from ..ops.dfa_scan import WindowScanner
        starts_all: List[np.ndarray] = []
        todo = np.arange(len(cand_end))
        W = 64
        j0 = (n - cand_end).astype(np.int64)  # flipped-coords lane starts
        MAXB = WindowScanner.MAX_LANES  # bounded per-launch lane batches
        while len(todo):
            nxt_parts: List[np.ndarray] = []
            for off in range(0, len(todo), MAXB):
                batch = todo[off:off + MAXB]
                B = _bucket(len(batch), 16)
                sb = np.zeros(B, dtype=np.int32)
                sb[:len(batch)] = j0[batch]
                Wc = min(W, n + 1)
                flags, alive = _window_scan_flags(
                    rp.delta, rp.match_on, rp.match_eoi,
                    rp.starts, rp.bounds, fdev, jnp.asarray(sb),
                    jnp.int32(n), jnp.full(B, n, dtype=jnp.int32), B=B,
                    W=Wc, S=rp.num_states, C=rp.num_classes)
                flags = np.asarray(jax.device_get(flags))[:len(batch)]
                alive = np.asarray(jax.device_get(alive))[:len(batch)]
                done = ~alive
                for row, lane in zip(np.nonzero(done)[0], batch[done]):
                    ts = np.nonzero(flags[row])[0]
                    if len(ts):
                        starts_all.append(n - (j0[lane] + ts))
                nxt_parts.append(batch[alive])
            todo = np.concatenate(nxt_parts) if nxt_parts else \
                np.empty(0, dtype=np.int64)
            W *= 4
            if W > 4 * (n + 1):
                # lanes alive beyond the full text length should be
                # impossible; if it ever happens, surface it as a
                # candidate-pipeline failure so callers fall back to the
                # exact full-scan path rather than silently dropping
                # those lanes' match starts
                from .config import debug
                debug(1, f"_rev_start_flags: {len(todo)} lanes alive past "
                         f"W={W}; falling back")
                return None
        if not starts_all:
            return np.empty(0, dtype=np.int64)
        out = np.unique(np.concatenate(starts_all))
        return out

    def _inner_spans(self, dev, data, n, limit) -> np.ndarray:
        from ..ops.bytescan import memmem, multi_literal_hits
        from ..ops.dfa_scan import WindowScanner
        if self._pf_retired:
            return self._full_scan_spans(dev, data, n, limit)
        sp = self.plan.split
        if len(sp.lits) == 1:
            k = len(sp.lit)
            cand = memmem(dev, sp.lit)
            cand_end = cand + k
        else:
            pos, _, plen = multi_literal_hits(dev, sp.lits)
            cand = pos
            cand_end = np.unique(pos + plen)
        if len(cand) == 0:
            return np.empty((0, 2), dtype=np.int64)
        if len(cand) > MAX_CANDIDATES:
            return self._full_scan_spans(dev, data, n, limit)
        starts = self._rev_start_flags(dev, data, n, cand_end)
        if starts is None:
            return self._full_scan_spans(dev, data, n, limit)
        if len(starts) == 0:
            return np.empty((0, 2), dtype=np.int64)
        ws = WindowScanner(self._dense(self._verify_kind()))
        ends = ws.ends_for_starts(dev, starts)
        keep = ends >= 0
        self._note_prefilter(keep)
        return go_select(starts[keep], ends[keep], n, data, limit)

    # runtime prefilter effectiveness tracking (prefilter/tracker.go:37
    # analogue): once enough candidates have been verified, a confirm
    # ratio below the threshold permanently retires the candidate
    # pipeline for this pattern (falls back to the full-scan spans path)
    PF_MIN_SAMPLES = 4096
    PF_MIN_RATIO = 1 / 64

    def _note_prefilter(self, keep: np.ndarray) -> None:
        """Prefilter effectiveness counters (meta.Stats
        PrefilterHits/Misses analogue): hits = candidates whose anchored
        verification produced a match end, misses = the rest."""
        h = int(keep.sum())
        self._pf_hits += h
        self._pf_seen += len(keep)
        if self.stats is not None:
            self.stats.prefilter_hits += h
            self.stats.prefilter_misses += len(keep) - h
        if (self._pf_seen >= self.PF_MIN_SAMPLES
                and self._pf_hits < self._pf_seen * self.PF_MIN_RATIO):
            from .config import debug
            debug(1, f"prefilter retired: {self._pf_hits}/{self._pf_seen} "
                     "confirm ratio below threshold")
            self._pf_retired = True

    def _prefix_set_spans(self, dev, data, n, limit) -> np.ndarray:
        """PREFIX_SET: candidate match starts = positions where any
        extracted prefix literal matches (meta/seq.py); verification =
        forward-anchored DFA windows.  The forward-only counterpart of
        _inner_spans — the reference instead wraps these literals in a
        memmem/Teddy prefilter (prefilter/prefilter.go:249-297)."""
        from ..ops.bytescan import multi_literal_hits
        from ..ops.dfa_scan import WindowScanner
        if self._pf_retired:
            return self._full_scan_spans(dev, data, n, limit)
        pos, _, _ = multi_literal_hits(dev, self.plan.prefix_lits)
        if len(pos) == 0:
            return np.empty((0, 2), dtype=np.int64)
        if len(pos) > MAX_CANDIDATES:
            return self._full_scan_spans(dev, data, n, limit)
        starts = np.unique(pos)
        ws = WindowScanner(self._dense(self._verify_kind()))
        ends = ws.ends_for_starts(dev, starts)
        keep = ends >= 0
        self._note_prefilter(keep)
        return go_select(starts[keep], ends[keep], n, data, limit)

    # .. bitset-NFA fallback (DFA overflow) ..............................
    def _bitset_scanner(self, kind: str):
        """Lazy BitsetNFAScanner for 'fwd' (match ends) or 'rev' (match
        starts over the flipped corpus); False when out of scope (looks,
        nullable, or too many range states)."""
        slot = "_bitset_fwd" if kind == "fwd" else "_bitset_rev"
        sc = getattr(self, slot)
        if sc is None:
            sc = False
            from ..ops.nfa_scan import BitsetNFAScanner, LookUnsupported
            try:
                nfa = compile_nfa(self.parsed, reverse=(kind == "rev"),
                                  with_captures=False)
                sc = BitsetNFAScanner(nfa)
            except LookUnsupported:
                pass
            setattr(self, slot, sc)
        return sc

    def _bitset_starts(self, data, n) -> Optional[np.ndarray]:
        """All match-start offsets via the reverse bitset-NFA scan on the
        flipped corpus (a flipped end at boundary j is a forward start at
        n - j); None = out of scope / non-convergence (host fallback)."""
        from ..utils.corpus_cache import device_corpus_flipped
        sc = self._bitset_scanner("rev")
        if not sc:
            return None
        fdev = device_corpus_flipped(data)
        ends, ok = sc.ends(fdev)
        if not ok or ends is None:
            return None
        return np.sort((n - ends).astype(np.int64))

    def _bitset_is_match(self, dev, n) -> Optional[bool]:
        import jax
        sc = self._bitset_scanner("fwd")
        if not sc:
            return None
        flags, conv = sc.flags(dev)
        if not bool(jax.device_get(conv)):
            return None
        from ..ops.bytescan import mask_count
        return int(jax.device_get(mask_count(flags[:n]))) > 0

    def _bitset_spans(self, dev, data, n, limit) -> Optional[np.ndarray]:
        """Spans for DFA-overflow patterns: device start discovery +
        anchored-DFA window verification when the ANCHORED automaton
        still determinizes (it is usually far smaller than the
        unanchored one), else host PikeVM ends on the sparse start set.
        Returns None = full host fallback."""
        from ..ops.dfa_scan import WindowScanner
        starts = self._bitset_starts(data, n)
        if starts is None:
            return None
        if len(starts) == 0:
            return np.empty((0, 2), dtype=np.int64)
        try:
            ws = WindowScanner(self._dense(self._verify_kind()))
            ends = ws.ends_for_starts(dev, starts)
            keep = ends >= 0
            return go_select(starts[keep], ends[keep], n, data, limit)
        except DFAOverflow:
            pass
        return self._spans_from_starts_host(data, n, starts, limit)

    # .. nullable factorization (meta/nullable.py) ........................
    def _core(self):
        """Lazy sub-engine over the non-empty core projection; its own
        strategy machinery (incl. artifact caches keyed by the derived
        pattern) serves the core's FindAll."""
        if self._core_engine is None:
            from .engine import Engine
            sub = Parsed(self.plan.core_ast, 0, [],
                         self.parsed.pattern + "<core>")
            self._core_engine = Engine(sub, longest=False)
        return self._core_engine

    def _nullable_core_spans(self, data, n, limit) -> np.ndarray:
        """FindAll(R) = FindAll(core) + empty fill-in (Go allMatches
        empty rules, /root/reference/meta/findall.go:176-283) — the core
        rides its own device strategy; the fill is vectorized host work
        proportional to the output."""
        from .nullable import fill_empties
        eng = self._core()
        core = None
        if n == 0:
            core = np.empty((0, 2), dtype=np.int64)
        try:
            if core is None:
                be = eng.batch_engine()
                if be.plan.strategy != Strategy.HOST:
                    core = be.find_all_spans(data, -1)
        except DFAOverflow:  # pragma: no cover - core-specific overflow
            core = None
        if core is None:
            # core device path out of scope: exact host walk over the
            # (non-nullable) core, still O(#matches)
            core = np.array(eng._all_spans(data),
                            dtype=np.int64).reshape(-1, 2)
        return fill_empties(np.asarray(core), n, data, limit)

    def _spans_from_starts_host(self, data, n, starts, limit
                                ) -> Optional[np.ndarray]:
        """Go FindAll restart walk over verified device-discovered starts
        with host PikeVM ends: the non-match regions were skipped on
        device; host work is O(total matched bytes)."""
        if self.host_find is None:
            return None
        out: List[Tuple[int, int]] = []
        pos = 0
        i = 0
        m = len(starts)
        while i < m and (limit < 0 or len(out) < limit):
            i = int(np.searchsorted(starts, pos, side="left"))
            if i >= m:
                break
            sp = self.host_find(data, int(starts[i]))
            if sp is None:  # pragma: no cover - fwd/rev disagree
                break
            out.append((int(sp[0]), int(sp[1])))
            # non-nullable (bitset gate): every match is non-empty
            pos = int(sp[1])
        return np.array(out, dtype=np.int64).reshape(-1, 2)

    # .. full scan ........................................................
    def _all_starts(self, dev, data, n) -> np.ndarray:
        """All match-start offsets via the reverse all-ends chunk scan,
        device-reduced to compact positions."""
        import jax
        from ..dfa.dense import CTX_SOT
        from ..ops.dfa_scan import ChunkScanner, flag_positions
        from ..utils.corpus_cache import device_corpus_flipped
        rev = self._dense("rev_all")
        fdev = device_corpus_flipped(data)
        sc = ChunkScanner(rev)
        flags, exits, conv, (L, T) = sc.scan_device(fdev)
        if not bool(jax.device_get(conv)):
            rflags, _ = sc._host_scan(fdev, None)
            starts = n - np.flatnonzero(rflags)
            return np.sort(starts)
        # flag at flipped offset j == match START at forward offset n - j
        jpos = flag_positions(flags, n)
        starts = n - jpos
        # flipped EOI (offset n) == match start at forward offset 0
        exit_n = sc._exit_at_n(fdev, exits, L, T, n)
        if rev.host_eoi[exit_n, CTX_SOT]:
            starts = np.append(starts, 0)
        return np.sort(starts.astype(np.int64))

    def _full_scan_spans(self, dev, data, n, limit) -> np.ndarray:
        from ..ops.dfa_scan import WindowScanner
        starts = self._all_starts(dev, data, n)
        if len(starts) == 0:
            return np.empty((0, 2), dtype=np.int64)
        ws = WindowScanner(self._dense(self._verify_kind()))
        ends = ws.ends_for_starts(dev, starts)
        keep = ends >= 0
        return go_select(starts[keep], ends[keep], n, data, limit)
