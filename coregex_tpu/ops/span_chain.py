"""Output-sensitive span assembly: fused mask->words producers + the
sparse compaction chain (round 5).

The round-4 span pipeline paid two full-corpus compactions plus eager
mask-algebra dispatch per find_all REGARDLESS of match density, where
the reference pays only its scan
(/root/reference/meta/findall.go:176-283).  This module restructures
extraction so the cost scales with MATCHES:

- each family's mask algebra runs inside ONE jit that emits the masks
  PRE-PACKED as 32-bit words (ops/compact2.pack_words fuses into the
  producer, so the corpus-sized bool mask never hits HBM) along with
  its hit counts;
- one host sync reads the counts (tight compaction caps);
- the 3-level sparse chain (ops/compact2.sparse_positions_words)
  extracts positions in nw + ~12*hits work instead of n;
- family assembly is pure XLA on hit-sized arrays.

Measured on chip: chain-from-words ~8.6 ms per 256 MB mask at 0.5%
density vs ~28 ms for the single-level kernel, with the pack cost
absorbed by producer fusion.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .bytescan import _class_mask_from_table, _memmem_mask, _range_mask
from .compact2 import pack_words, sparse_positions_words

# sparse-chain crossover (hits/n): below this the chain wins; above it
# callers keep their dense single-level pipelines
SPARSE_OK = 1.0 / 18


def _pad_pack(m, n: int):
    """Pack a [n] mask into words, padded to a POWER-OF-TWO word count:
    downstream chain programs are then cached per (bucket, cap) instead
    of per exact corpus length (program-cache hygiene; see
    compact2.sparse_positions_words)."""
    from .compact2 import _bucket_up
    nw = _bucket_up(max(-(-n // 32), 1))
    pad = nw * 32 - n
    if pad:
        m = jnp.concatenate([m, jnp.zeros(pad, dtype=bool)])
    return pack_words(m, nw)


def _count(m):
    return m.sum(dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Producers: one fused dispatch -> (words..., counts...)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("lit",))
def literal_words(dev, lit: Tuple[int, ...]):
    """(start-words, count) for an exact non-self-overlapping literal."""
    n = dev.shape[0]
    m = _memmem_mask(dev, lit)
    return _pad_pack(m, n), _count(m)


@functools.partial(jax.jit, static_argnames=("ranges", "mmin"))
def class_run_words(dev, ranges, mmin: int):
    """(start-words, end-words, scount, ecount) for maximal runs of the
    class (length >= mmin; ends exclusive-1, i.e. LAST member position
    like _run_masks).  Used by the charclass family when runs are
    sparse."""
    n = dev.shape[0]
    mask = _range_mask(dev, ranges)
    prev = jnp.concatenate([jnp.zeros(1, bool), mask[:-1]])
    nxt = jnp.concatenate([mask[1:], jnp.zeros(1, bool)])
    smask = mask & ~prev
    emask = mask & ~nxt
    if mmin > 1:
        ok_fwd = mask
        ok_bwd = mask
        for j in range(1, mmin):
            z = jnp.zeros(j, dtype=bool)
            ok_fwd = ok_fwd & jnp.concatenate([mask[j:], z])
            ok_bwd = ok_bwd & jnp.concatenate([z, mask[:-j]])
        smask = smask & ok_fwd
        emask = emask & ok_bwd
    return (_pad_pack(smask, n), _pad_pack(emask, n),
            _count(smask), _count(emask))


@functools.partial(jax.jit, static_argnames=("ranges", "mmin"))
def class_run_masks_dense(dev, ranges, mmin: int):
    """Bool (smask, emask) twins of class_run_words for the dense
    single-level fallback (run density too high for the chain)."""
    mask = _range_mask(dev, ranges)
    prev = jnp.concatenate([jnp.zeros(1, bool), mask[:-1]])
    nxt = jnp.concatenate([mask[1:], jnp.zeros(1, bool)])
    smask = mask & ~prev
    emask = mask & ~nxt
    if mmin > 1:
        ok_fwd = mask
        ok_bwd = mask
        for j in range(1, mmin):
            z = jnp.zeros(j, dtype=bool)
            ok_fwd = ok_fwd & jnp.concatenate([mask[j:], z])
            ok_bwd = ok_bwd & jnp.concatenate([z, mask[:-j]])
        smask = smask & ok_fwd
        emask = emask & ok_bwd
    return smask, emask


@functools.partial(jax.jit, static_argnames=("lits",))
def multi_literal_words(dev, lits: Tuple[Tuple[int, ...], ...]):
    """(start-words, end-words, scount, ecount) for an exact literal
    alternation, within-position priority resolved (first listed wins),
    all-bool algebra (no corpus-sized int32)."""
    n = dev.shape[0]
    seen = jnp.zeros(n, dtype=bool)
    emask = jnp.zeros(n + 1, dtype=bool)
    for lit in lits:
        hit = _memmem_mask(dev, lit)
        win = hit & ~seen
        seen = seen | hit
        k = len(lit)
        emask = emask.at[k:].set(emask[k:] | win[:n + 1 - k])
    smask = seen  # priority only affects END choice; starts = any hit
    return (_pad_pack(smask, n), _pad_pack(emask, n + 1),
            _count(smask), _count(emask))


# one fused jit across ALL J literals at full corpus scale exceeds HBM
# (each literal's rolled-compare transients are corpus-sized bools); the
# big variant SEGMENTS the corpus and reuses the proven fused algebra
# per ~256 MB slice.  Exact: the only cross-position state (priority)
# is per-position, so slices are independent given a kmax-1 halo.
MULTI_FUSED_LIMIT = 384 * 1024 * 1024
_ML_SEG = 256 * 1024 * 1024


def _shift_words(win, k: int, out_len: int):
    """OR-target word array for shifted bits: bit p of win -> bit p+k
    of the result ([out_len] words, uint32 logical shifts)."""
    wu = win.astype(jnp.uint32)
    woff, bs = k // 32, k % 32
    a = (wu << bs).astype(jnp.int32) if bs else win
    za = jnp.zeros(woff, dtype=jnp.int32)
    out = jnp.concatenate([za, a])[:out_len]
    if out.shape[0] < out_len:
        out = jnp.concatenate(
            [out, jnp.zeros(out_len - out.shape[0], jnp.int32)])
    if bs:
        b = (wu >> (32 - bs)).astype(jnp.int32)
        zb = jnp.zeros(woff + 1, dtype=jnp.int32)
        ob = jnp.concatenate([zb, b])[:out_len]
        if ob.shape[0] < out_len:
            ob = jnp.concatenate(
                [ob, jnp.zeros(out_len - ob.shape[0], jnp.int32)])
        out = out | ob
    return out


@functools.partial(jax.jit, static_argnames=("lits", "lead", "emit_n"))
def _ml_slice_words(ext, lits, lead: int, emit_n: int):
    """Word-packed (starts, ends) for emit positions [lead, lead+emit_n)
    of the extended slice; ends emitted over emit_n MASK slots (the
    caller gives the last slice emit_n = tail+1 so an end at n fits)."""
    m = ext.shape[0]
    seen = jnp.zeros(m, dtype=bool)
    emask = jnp.zeros(emit_n, dtype=bool)
    for lit in lits:
        hit = _memmem_mask(ext, lit)
        win = hit & ~seen
        seen = seen | hit
        k = len(lit)
        # end bit j (global a+j) <- win at local j + lead - k
        lo = lead - k
        if lo >= 0:
            seg = win[lo:lo + emit_n]
        else:
            seg = jnp.concatenate(
                [jnp.zeros(-lo, dtype=bool), win])[:emit_n]
        if seg.shape[0] < emit_n:
            seg = jnp.concatenate(
                [seg, jnp.zeros(emit_n - seg.shape[0], dtype=bool)])
        emask = emask | seg
    smask = seen[lead:lead + emit_n]
    if smask.shape[0] < emit_n:
        smask = jnp.concatenate(
            [smask, jnp.zeros(emit_n - smask.shape[0], dtype=bool)])
    nw = emit_n // 32
    return pack_words(smask, nw), pack_words(emask, nw)


@jax.jit
def _ml_counts(seen_w, ew):
    pc = jax.lax.population_count
    return (pc(seen_w).sum(dtype=jnp.int32),
            pc(ew).sum(dtype=jnp.int32))


def multi_literal_words_big(dev, lits: Tuple[Tuple[int, ...], ...]):
    """multi_literal_words past MULTI_FUSED_LIMIT: same contract
    (start-words and end-words bucket-padded, end mask domain n+1)."""
    from .compact2 import _bucket_up
    n = int(dev.shape[0])
    kmax = max(len(l) for l in lits)
    # per-slice transients scale with J (each literal's rolled-compare
    # bools): shrink slices so the slice program stays within HBM
    # (J=32 at 256 MB slices compile-OOMed by ~0.5 GB)
    seg = max(32 * 1024 * 1024,
              _ML_SEG * 8 // max(8, len(lits)))
    seg -= seg % 32
    ws_parts, we_parts = [], []
    a = 0
    while a < n:
        b = min(a + seg, n)
        last = b == n
        lo = max(0, a - (kmax - 1))
        hi = min(n, b + kmax - 1)
        emit = b - a if not last else (n + 1 - a)
        emit_pad = -(-emit // 32) * 32
        ext = dev[lo:hi]
        sw, ew_ = _ml_slice_words(ext, lits, a - lo, emit_pad)
        ws_parts.append(sw)
        we_parts.append(ew_)
        a = b
    ws = jnp.concatenate(ws_parts) if len(ws_parts) > 1 else ws_parts[0]
    we = jnp.concatenate(we_parts) if len(we_parts) > 1 else we_parts[0]
    nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
    if int(ws.shape[0]) < nwb1:
        pad = jnp.zeros(nwb1 - int(ws.shape[0]), dtype=jnp.int32)
        ws = jnp.concatenate([ws, pad])
        we = jnp.concatenate([we, pad])
    cs, ce = _ml_counts(ws, we)
    return ws, we, cs, ce


# ---------------------------------------------------------------------------
# Line-shape family on the event stream
# ---------------------------------------------------------------------------
# Events: bit0 = newline, bit1 = literal candidate (newline-free lit, so
# "fits before EOL" is automatic), bit2 = line-start-with-prefix (only
# for (?m)^P anchored shapes).  All per-line logic then runs on the
# compacted hit-sized stream: running maxima replace the corpus-sized
# cummax cascades of the round-4 line_span_masks (the r4 line find_all
# cost ~0.7 s per 256 MB; the stream is O(lines + candidates)).

@functools.partial(jax.jit, static_argnames=("lit", "prefix",
                                             "line_anchored"))
def line_event_words(dev, lit: Tuple[int, ...], prefix: Tuple[int, ...],
                     line_anchored: bool):
    """(words_nl, words_cand, words_ls or None, counts...) — one fused
    dispatch."""
    n = dev.shape[0]
    is_nl = dev == np.uint8(10)
    cand = _memmem_mask(dev, lit)
    outs = [_pad_pack(is_nl, n), _pad_pack(cand, n)]
    cnts = [_count(is_nl), _count(cand)]
    if line_anchored:
        prev = jnp.concatenate(
            [jnp.full(1, np.uint8(10), dev.dtype), dev[:-1]])
        is_ls = (jnp.arange(n, dtype=jnp.int32) == 0) | \
            (prev == np.uint8(10))
        lsp = is_ls & (_memmem_mask(dev, prefix) if len(prefix)
                       else jnp.ones(n, dtype=bool))
        outs.append(_pad_pack(lsp, n))
        cnts.append(_count(lsp))
    return tuple(outs), tuple(cnts)


def _cummax_i32(x):
    return jax.lax.cummax(x)


@functools.partial(jax.jit, static_argnames=("cap", "mode", "anchored",
                                             "k", "plen"))
def _line_stream_spans(pos, kind, cnt, n_dev, cap: int, mode: str,
                       anchored: bool, k: int, plen: int):
    """Event stream -> line-shape spans.  pos/kind are [cap] from
    sparse_events_words; cnt excludes the virtual EOT terminator this
    function splices at index cnt (pos there is already the sentinel
    n)."""
    from .compact2 import compact_pay
    idx = jnp.arange(cap, dtype=jnp.int32)
    # virtual EOT line terminator (a final line without trailing \n);
    # harmless when the corpus ends in \n (empty line -> no match)
    kind = jnp.where(idx == cnt, jnp.int32(1), kind)
    live = idx <= cnt
    isnl = live & ((kind & 1) != 0)
    iscand = live & ((kind & 2) != 0)
    NEG = jnp.int32(-1)
    pnl_incl = _cummax_i32(jnp.where(isnl, pos, NEG))
    pnl_excl = jnp.concatenate([jnp.full(1, NEG, jnp.int32),
                                pnl_incl[:-1]])
    if anchored:
        isls = live & ((kind & 4) != 0)
        lsm = _cummax_i32(jnp.where(isls, pos, NEG))
        # candidate's line starts with the prefix, and the candidate
        # sits at/after line_start + plen (events at a cand are not nl,
        # so pnl_incl is its strictly-previous newline)
        good = (lsm == pnl_incl + 1) & (pos >= pnl_incl + 1 + plen)
        valid = iscand & good
    else:
        valid = iscand
    lv_incl = _cummax_i32(jnp.where(valid, pos, NEG))
    lv_excl = jnp.concatenate([jnp.full(1, NEG, jnp.int32),
                               lv_incl[:-1]])
    if mode == "first_to_eol":
        first_mark = valid & (lv_excl <= pnl_incl)
        fc_incl = _cummax_i32(jnp.where(first_mark, pos, NEG))
    # at a NL event, pnl_excl is the PREVIOUS newline (the event itself
    # is excluded by the shift iff ... pnl_incl at the nl event includes
    # itself, so the line's opener is pnl_excl)
    line_has = isnl & (lv_incl > pnl_excl)
    if mode == "first_to_eol":
        starts = fc_incl
        ends = pos
    elif mode == "bol_to_last":
        starts = pnl_excl + 1
        ends = lv_incl + k
    else:  # bol_to_eol
        starts = pnl_excl + 1
        ends = pos
    out = compact_pay(line_has, [starts, ends], cap)
    _, s_c, e_c, cntm, okc = out
    livem = jnp.arange(cap, dtype=jnp.int32) < cntm
    ok = okc & jnp.all(jnp.where(livem, s_c < e_c, True))
    nxt = jnp.concatenate([s_c[1:], jnp.full(1, 2**31 - 1, jnp.int32)])
    liven = jnp.arange(cap, dtype=jnp.int32) < cntm - 1
    ok &= jnp.all(jnp.where(liven, e_c <= nxt, True))
    e_c = jnp.where(livem, e_c, s_c)
    s_c = jnp.where(livem, s_c, n_dev)
    return jnp.stack([s_c, e_c], axis=1), cntm, ok


@functools.partial(jax.jit, static_argnames=("nwb", "cap", "mode",
                                             "anchored", "k", "plen"))
def _line_cand_spans_jit(candw, nlw, lspw, n_dev, nwb: int, cap: int,
                         mode: str, anchored: bool, k: int, plen: int):
    """Candidate-only line extraction (round 5b): ONE chain over the
    candidate words with the newline (and anchored line-start-prefix)
    words + prev/next position tables riding as payloads — newlines
    never become events, so the chain and all hit-sized algebra scale
    with CANDIDATES (the event-stream form paid for every newline:
    ~27M events per 1.6 GB, ~0.5 s per find_all)."""
    from .compact2 import compact_pay, sparse_chain_payloads
    ONE = jnp.int32(1)
    lastnl_w = _word_lastpos_table(nlw, nwb)
    nextnl_w = _word_nextpos_table(nlw, nwb)
    pays = [nlw, lastnl_w, nextnl_w]
    if anchored:
        lastlsp_w = _word_lastpos_table(lspw, nwb)
        pays += [lspw, lastlsp_w]
    # dead-event sentinel (nwb*32 overflows int32 at the 1.6 GB bucket)
    out = sparse_chain_payloads(candw, pays, 2 ** 31 - 1, cap)
    if anchored:
        (c_pos, nlw_i, lastnl_i, nextnl_i, lspw_i, lastlsp_i,
         cnt, okc) = out
    else:
        c_pos, nlw_i, lastnl_i, nextnl_i, cnt, okc = out
    idx = jnp.arange(cap, dtype=jnp.int32)
    live = idx < cnt
    bitc = c_pos & 31
    below = jnp.left_shift(ONE, bitc) - ONE          # bits < bitc
    at_or_below = below | jnp.left_shift(ONE, bitc)  # bits <= bitc
    v = nlw_i & below
    pnl = jnp.where(v != 0, (c_pos & ~31) + _floor_log2(v), lastnl_i)
    bol = pnl + 1
    v2 = nlw_i & ~below                              # bits >= bitc
    eol = jnp.where(v2 != 0, (c_pos & ~31) + _ctz32(v2), nextnl_i)
    eol = jnp.minimum(eol, n_dev)  # final unterminated line ends at n
    if anchored:
        v3 = lspw_i & at_or_below
        lsp_last = jnp.where(v3 != 0, (c_pos & ~31) + _floor_log2(v3),
                             lastlsp_i)
        valid = live & (lsp_last == bol) & (c_pos >= bol + plen)
    else:
        valid = live
    if mode == "bol_to_last":
        # keep the LAST valid candidate per line: its line's BOL is
        # smaller than every later valid candidate's BOL
        # bol never decreases along the candidates, so the least later
        # valid BOL is the next valid candidate's
        nxtmin = jnp.concatenate([
            next_value(valid, bol, jnp.int32(_POS_BIG))[1:],
            jnp.full(1, _POS_BIG, jnp.int32)])
        keep = valid & (bol < nxtmin)
        s_v, e_v = bol, c_pos + k
    else:
        # first valid candidate per line
        bolv = jnp.where(valid, bol, jnp.int32(-1))
        prevmax = jnp.concatenate(
            [jnp.full(1, -1, jnp.int32), cummax_fast(bolv, -1)[:-1]])
        keep = valid & (bol > prevmax)
        if mode == "first_to_eol":
            s_v, e_v = c_pos, eol
        else:  # bol_to_eol
            s_v, e_v = bol, eol
    out2 = compact_pay(keep, [s_v, e_v], cap)
    _, s_c, e_c, cntm, okc2 = out2
    livem = jnp.arange(cap, dtype=jnp.int32) < cntm
    ok = okc & okc2 & jnp.all(jnp.where(livem, s_c < e_c, True))
    nxt = jnp.concatenate([s_c[1:], jnp.full(1, 2 ** 31 - 1,
                                             jnp.int32)])
    liven = jnp.arange(cap, dtype=jnp.int32) < cntm - 1
    ok &= jnp.all(jnp.where(liven, e_c <= nxt, True))
    e_c = jnp.where(livem, e_c, s_c)
    s_c = jnp.where(livem, s_c, n_dev)
    return jnp.stack([s_c, e_c], axis=1), cntm, ok


def line_spans_candidates(words, n: int, cap: int, mode: str,
                          anchored: bool, k: int, plen: int):
    """Candidate-chain line extraction from line_event_words' outputs
    (cap bounds CANDIDATES, not newline events).  Returns
    (spans [cap,2], match count DEVICE scalar, ok DEVICE bool)."""
    from .compact2 import _bucket_up
    nlw = words[0]
    candw = words[1]
    lspw = words[2] if anchored else candw
    nwb = _bucket_up(max(int(candw.shape[0]), 1))
    return _line_cand_spans_jit(
        _fit_words(candw, nwb), _fit_words(nlw, nwb),
        _fit_words(lspw, nwb), _dev_i32(n), nwb, cap, mode, anchored,
        k, plen)


def line_spans_events(kind_words, n: int, cap: int, mode: str,
                      anchored: bool, k: int, plen: int,
                      cnt_events):
    """Full line-shape extraction from event-mask words: stream chain +
    per-line algebra + one payload compaction.  cap must bound
    events + 1 (the virtual EOT terminator).  Returns
    (spans [cap,2], match-count DEVICE scalar, ok DEVICE bool)."""
    from .compact2 import sparse_events_words
    pos, kind, cnt, ok1 = sparse_events_words(kind_words, n, cap)
    spans, cntm, ok2 = _line_stream_spans(
        pos, kind, cnt, _dev_i32(n), cap, mode, anchored, k, plen)
    return spans, cntm, ok1 & ok2


# ---------------------------------------------------------------------------
# INNER family on the event stream + per-word payload tables
# ---------------------------------------------------------------------------
# email/url shapes ([class-run] lit suffix): candidates are lit
# occurrences with >= m class members before them; the suffix is
# verified by one ResetScanner pass (resets at candidate+k); per-
# candidate run starts and last-flag-in-interval then resolve from
# per-WORD tables riding the payload chain — replacing the round-4
# corpus-sized cummin cascades and three separate compactions.

def _floor_log2(v):
    """floor(log2(v)) for int32 v>0 via smear+popcount (exact — a f32
    conversion could round 2^k-1 up and lie about the exponent);
    returns -1 for v == 0.  Bit 31 set smears to all-ones -> 31."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    return jax.lax.population_count(v) - 1


def cummax_fast(x, neg):
    """Inclusive running max of a 1-D int32 array via a 2-D reshape
    (XLA's 1-D cummax lowers to many full passes at tens of millions of
    elements); `neg` = identity element."""
    m = int(x.shape[0])
    C = 1024
    R = -(-m // C)
    pad = R * C - m
    if pad:
        x = jnp.concatenate([x, jnp.full(pad, neg, x.dtype)])
    x2 = x.reshape(R, C)
    row = jax.lax.cummax(x2, axis=1)
    rmax = row[:, -1]
    carry = jnp.concatenate([jnp.full(1, neg, x.dtype),
                             jax.lax.cummax(rmax)[:-1]])
    return jnp.maximum(row, carry[:, None]).reshape(-1)[:m]


def next_value(mask, values, big):
    """out[i] = values[j] for the first j >= i with mask[j], else `big`.

    A forward rank + scatter + gather: the set entries' values are
    compacted by rank, and position i reads the entry whose rank is the
    number of set entries before i.  (The reversed running minimum this
    replaces, flip -> cummax -> flip, returned wrong values on the GPU
    at 2^21+ elements.)"""
    n = mask.shape[0]
    m = mask.astype(jnp.int32)
    rank = jnp.cumsum(m) - m
    slot = jnp.where(mask, rank, n + 1)
    table = jnp.full(n + 1, big, values.dtype).at[slot].set(
        values, mode="drop")
    return table[rank]


def _word_lastpos_table(bits_w, nw: int):
    """lastpos_w[i] = highest set-bit POSITION strictly before word i
    (-1 if none): per-word top bit + exclusive running max."""
    base = jnp.arange(nw, dtype=jnp.int32) * 32
    top = jnp.where(bits_w != 0, base + _floor_log2(bits_w),
                    jnp.int32(-1))
    incl = cummax_fast(top, -1)
    return jnp.concatenate([jnp.full(1, -1, jnp.int32), incl[:-1]])


def _ctz32(v):
    """Lowest set-bit index of int32 v != 0 (count trailing zeros)."""
    return _floor_log2(v & jnp.negative(v))


# "no position" sentinel: must exceed EVERY real position — corpora run
# past 2^30 bytes, so use INT32_MAX (a 2^30 sentinel silently undercut
# real next-positions beyond 1.07 GB)
_POS_BIG = 2 ** 31 - 1


def _word_nextpos_table(bits_w, nw: int):
    """nextpos_w[i] = lowest set-bit POSITION strictly after word i
    (_POS_BIG if none)."""
    base = jnp.arange(nw, dtype=jnp.int32) * 32
    low = base + _ctz32(bits_w)
    incl = next_value(bits_w != 0, low, jnp.int32(_POS_BIG))
    return jnp.concatenate([incl[1:],
                            jnp.full(1, _POS_BIG, jnp.int32)])


@functools.partial(jax.jit, static_argnames=("ranges", "lit", "m",
                                             "bounds"))
def inner_cand_symbols(dev, ranges, lit: Tuple[int, ...], m: int,
                       bounds: Tuple[int, ...]):
    """inner_cand_arrays fused with the flag scan's symbol build (the
    two share the corpus pass): returns (candw, mw, lastnm_w,
    symbols u8 [n+32], cand_count)."""
    from .compact2 import _bucket_up
    n = dev.shape[0]
    k = len(lit)
    member = _range_mask(dev, ranges)
    hit = _memmem_mask(dev, lit)
    valid = hit
    for j in range(1, m + 1):
        valid = valid & jnp.concatenate(
            [jnp.zeros(j, dtype=bool), member[:-j]])
    valid = valid & (jnp.arange(n, dtype=jnp.int32) <= n - k - 1)
    rmask = jnp.concatenate([jnp.zeros(k, dtype=bool), valid[:-k]]) \
        if k < n else jnp.zeros(n, dtype=bool)
    nwb = _bucket_up(max(-(-int(n) // 32), 1))
    candw = _pad_pack(valid, n)
    mw = _pad_pack(member, n)
    nonm_w = _pad_pack(~member, n)
    lastnm_w = _word_lastpos_table(nonm_w, nwb)
    cls = jnp.zeros(dev.shape, dtype=jnp.int32)
    for b in bounds:
        cls = cls + (dev >= np.uint8(b)).astype(jnp.int32)
    sym = (2 * cls + rmask.astype(jnp.int32)).astype(jnp.uint8)
    sym = jnp.concatenate([sym, jnp.zeros(32, dtype=jnp.uint8)])
    return candw, mw, lastnm_w, sym, _count(valid)


@functools.partial(jax.jit, static_argnames=("ranges", "lit", "m"))
def inner_cand_arrays(dev, ranges, lit: Tuple[int, ...], m: int):
    """(candw, mw, lastnm_w, rmask bool[n], cand_count) — one fused
    dispatch.  Candidates = lit occurrences with >= m members
    immediately before AND c + k < n (a nonempty suffix cannot match at
    EOI, and the reset bit must exist)."""
    from .compact2 import _bucket_up
    n = dev.shape[0]
    k = len(lit)
    member = _range_mask(dev, ranges)
    hit = _memmem_mask(dev, lit)
    valid = hit
    for j in range(1, m + 1):
        valid = valid & jnp.concatenate(
            [jnp.zeros(j, dtype=bool), member[:-j]])
    valid = valid & (jnp.arange(n, dtype=jnp.int32) <= n - k - 1)
    rmask = jnp.concatenate([jnp.zeros(k, dtype=bool), valid[:-k]]) \
        if k < n else jnp.zeros(n, dtype=bool)
    nwb = _bucket_up(max(-(-int(n) // 32), 1))
    candw = _pad_pack(valid, n)
    mw = _pad_pack(member, n)
    nonm_w = _pad_pack(~member, n)
    lastnm_w = _word_lastpos_table(nonm_w, nwb)
    return candw, mw, lastnm_w, rmask, _count(valid)


@jax.jit
def inner_flag_arrays(flag, eoi_flag):
    """(flagw over the [n+1] domain, lastflag_w, global-last-flag) from
    the suffix scan's per-position flags + EOI acceptance."""
    from .compact2 import _bucket_up
    n = int(flag.shape[0])
    flag1 = jnp.concatenate([flag, eoi_flag.reshape(1)])
    nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
    flagw = _pad_pack(flag1, n + 1)
    lastflag_w = _word_lastpos_table(flagw, nwb1)
    base = jnp.arange(nwb1, dtype=jnp.int32) * 32
    top = jnp.where(flagw != 0, base + _floor_log2(flagw),
                    jnp.int32(-1))
    glob = top.max()
    return flagw, lastflag_w, glob


@functools.partial(jax.jit, static_argnames=("nwb1",))
def inner_flag_arrays_words(fw_raw, nwb1: int):
    """As inner_flag_arrays but from the FlagResetScanner's word output
    (already covering the [n+1] domain, bits past n masked): pads to
    the chain bucket and derives the per-word tables."""
    m = int(fw_raw.shape[0])
    if m < nwb1:
        flagw = jnp.concatenate(
            [fw_raw, jnp.zeros(nwb1 - m, dtype=jnp.int32)])
    else:
        flagw = fw_raw[:nwb1]
    lastflag_w = _word_lastpos_table(flagw, nwb1)
    base = jnp.arange(nwb1, dtype=jnp.int32) * 32
    top = jnp.where(flagw != 0, base + _floor_log2(flagw),
                    jnp.int32(-1))
    glob = top.max()
    return flagw, lastflag_w, glob


@functools.partial(jax.jit, static_argnames=("cap", "k", "m", "M",
                                             "b_empty"))
def inner_assemble(c_pos, mw_i, lastnm_i, r_pos, flagw_i, lastflag_i,
                   cntA, cntB, okAB, glob_lf, conv, interf, n_dev,
                   cap: int, k: int, m: int, M: int,
                   b_empty: bool = False, fixed_ends=None):
    """Per-candidate (smin, smax, end) from the chained payloads +
    flexible Go selection + compaction of the selected spans.
    Returns (spans [cap,2], nsel, ok).  b_empty: no suffix — every
    candidate verified with the caller's fixed_ends."""
    from .compact2 import compact_pay
    from .span_kernels import _go_select_flex_round
    idx = jnp.arange(cap, dtype=jnp.int32)
    live = idx < cntA
    ONE = jnp.int32(1)
    # smin: last nonmember before the candidate, in-word bits first
    bitc = c_pos & 31
    v = (~mw_i) & ((ONE << bitc) - 1)
    lastnm = jnp.where(v != 0, (c_pos & ~31) + _floor_log2(v),
                       lastnm_i)
    smin = lastnm + 1
    if M != -1:
        smin = jnp.maximum(smin, c_pos - M)
    smax = c_pos - m
    if b_empty:
        ends = fixed_ends
        verified = live
    else:
        # end: last flag strictly inside (r_i, r_{i+1}); LF[i] = last
        # flag strictly before r_i comes from event i's own payloads,
        # so the interval end is LF[i+1] (the final interval uses the
        # global last flag, which includes the EOI bit at n)
        bitr = r_pos & 31
        vf = flagw_i & ((ONE << bitr) - 1)
        lf_here = jnp.where(vf != 0, (r_pos & ~31) + _floor_log2(vf),
                            lastflag_i)
        ends = jnp.concatenate([lf_here[1:],
                                jnp.full(1, 0, jnp.int32)])
        ends = jnp.where(idx == cntA - 1, glob_lf, ends)
        verified = live & (ends > r_pos)
    smax_sel = jnp.where(verified, smax, jnp.int32(-2))
    sel, stable, starts = _go_select_flex_round(
        smin, smax_sel, ends, verified, rounds=24)
    sel = sel & verified
    out = compact_pay(sel, [starts, ends], cap)
    _, s_c, e_c, nsel, okc = out
    livem = jnp.arange(cap, dtype=jnp.int32) < nsel
    e_c = jnp.where(livem, e_c, s_c)
    s_c = jnp.where(livem, s_c, n_dev)
    ok = okAB & okc & stable & (cntA == cntB) & conv & ~interf
    return jnp.stack([s_c, e_c], axis=1), nsel, ok


# ---------------------------------------------------------------------------
# Bidirectional span assembly (PREFIX_RUN / FULL_SCAN families, round 5)
# ---------------------------------------------------------------------------
# Forward: the span-event scan (ops/span_scan.py) emits flag + first-flag
# words; flags partition into consecutive per-match groups, each group's
# LAST flag is a committed match end (EOI kind resolves the tail).
# Reverse: a FlagResetScanner over the FLIPPED corpus with resets at the
# reversed ends and pre-reset flag semantics — each reset interval's last
# flag (furthest back == leftmost) is the match start, and the truncation
# at the previous end IS Go's "start >= previous end" rule.  Reference
# analogue: the 2-pass bidirectional FindAll fast path,
# /root/reference/meta/findall.go:216-239.

# EOI kinds (dfa/countdfa.py)
_EOI_EXTEND = 1
_EOI_EXTRA = 2
_EOI_COMPLEX = 3


def _fit_words(w, nwb: int):
    m = int(w.shape[0])
    if m < nwb:
        return jnp.concatenate([w, jnp.zeros(nwb - m, dtype=jnp.int32)])
    return w[:nwb]


@functools.partial(jax.jit, static_argnames=("capM", "nwb", "nwb1"))
def bidi_ends(flagw, firstw, n_dev, total, kind, capM: int, nwb: int,
              nwb1: int):
    """Forward events -> (ends [capM] ascending, final count, reversed
    reset positions rq [capM] ascending (dead = 2^30), reset words
    [nwb1], ok).  One dispatch; no corpus-sized work — the reverse
    scan's symbol tiles are cached per corpus and rq scatters into
    them (ops/flag_scan.scatter_reset_tiles).

    Only FIRST flags compact (exactly one per committed group — the
    greedy extension flags that outnumber matches never become events);
    each group's last flag resolves from the flag-word + last-flag
    tables riding the chain as payloads: it is the last flag STRICTLY
    BEFORE the next group's first flag (groups are consecutive), with
    the global last flag closing the final group.  Then the EOI-kind
    tail fixup, count parity check, and the reverse scan's fused
    symbol/reset build."""
    from .compact2 import sparse_chain_payloads
    # dead-event sentinel for the chain (any value >= n works; nwb*32
    # hits exactly 2^31 at the 1.6 GB bucket and overflows int32)
    n = 2 ** 31 - 1
    ONE = jnp.int32(1)
    fw = _fit_words(flagw, nwb)
    gw = _fit_words(firstw, nwb)
    lastflag_w = _word_lastpos_table(fw, nwb)
    base = jnp.arange(nwb, dtype=jnp.int32) * 32
    top = jnp.where(fw != 0, base + _floor_log2(fw), jnp.int32(-1))
    glob_f = top.max()
    f_pos, fwi, lfi, cntM, okE = sparse_chain_payloads(
        gw, [fw, lastflag_w], n, capM)
    idm = jnp.arange(capM, dtype=jnp.int32)
    live = idm < cntM
    bitf = f_pos & 31
    vf = fwi & (jnp.left_shift(ONE, bitf) - ONE)  # strictly below
    lfb = jnp.where(vf != 0, (f_pos & ~31) + _floor_log2(vf), lfi)
    ends_c = jnp.concatenate([lfb[1:], jnp.zeros(1, dtype=jnp.int32)])
    ends_c = jnp.where(idm == cntM - 1, glob_f, ends_c)
    ok = okE & jnp.all(jnp.where(live, ends_c >= f_pos, True))
    ends_c = jnp.where(live, ends_c, n_dev)
    ends_c = jnp.where((idm == cntM - 1) & (kind == _EOI_EXTEND),
                       n_dev, ends_c)
    extra = (kind == _EOI_EXTRA).astype(jnp.int32)
    ends_c = jnp.where((idm == cntM) & (extra == 1), n_dev, ends_c)
    cntF = cntM + extra
    ok &= (cntF == total) & (kind != _EOI_COMPLEX)
    liveF = idm < cntF
    # reversed reset positions, emitted in ASCENDING order (flip the
    # ascending ends) with sorted/unique scatter hints — XLA lowers the
    # hinted scatters an order of magnitude faster than the general
    # one.  The flip is jnp.flip + a dynamic roll: a jnp.take with
    # reversed indices costs ~13 ms per 2M elements on this chip, the
    # roll is a pair of dynamic slices
    ends_f = jnp.roll(jnp.flip(ends_c), cntF - capM)
    # dead entries carry rq = -1: at the 1.6 GB corpus bucket the word
    # arrays span all of int32 (2^26 words x 32), so no POSITIVE
    # sentinel is out of range — only a negative index drops
    rq = jnp.where(liveF, n_dev - ends_f, jnp.int32(-1))
    rw = jnp.zeros(nwb1, dtype=jnp.int32).at[rq >> 5].add(
        jnp.left_shift(ONE, rq & 31), mode="drop")
    return ends_c, cntF, rq, rw, ok


@functools.partial(jax.jit, static_argnames=("capM", "nwb1"))
def bidi_assemble(ends_c, cntF, rw, fw_rev, n_dev, capM: int,
                  nwb1: int):
    """Reverse flags -> spans.  Reset events (ascending reversed
    position == descending ends) carry flag-word payloads; each
    interval's last flag AT-OR-BEFORE the next reset is the leftmost
    viable start; flip to ascending and cross-check against the
    forward ends.  Returns (spans [capM,2], count, ok)."""
    from .compact2 import sparse_chain_payloads
    ONE = jnp.int32(1)
    flagw_r, lastflag_r, glob = inner_flag_arrays_words(
        _fit_words(fw_rev, nwb1), nwb1)
    r_pos, fwi, lfi, cntR, okR = sparse_chain_payloads(
        rw, [flagw_r, lastflag_r], n_dev + 1, capM)
    idx = jnp.arange(capM, dtype=jnp.int32)
    live = idx < cntR
    bitr = r_pos & 31
    hi = jnp.left_shift(ONE, bitr)
    m_incl = hi | (hi - ONE)
    vf = fwi & m_incl
    lfab = jnp.where(vf != 0, (r_pos & ~31) + _floor_log2(vf), lfi)
    q_i = jnp.concatenate([lfab[1:], jnp.zeros(1, dtype=jnp.int32)])
    q_i = jnp.where(idx == cntR - 1, glob, q_i)
    ok = okR & (cntR == cntF) & jnp.all(
        jnp.where(live, q_i > r_pos, True))
    s_rev = n_dev - q_i
    e_rev = n_dev - r_pos
    # ascending-span order = flip + dynamic roll (not a take: ~13 ms
    # per 2M elements vs sub-ms for slice-based roll)
    s_a = jnp.roll(jnp.flip(s_rev), cntR - capM)
    e_a = jnp.roll(jnp.flip(e_rev), cntR - capM)
    s_a = jnp.where(live, s_a, n_dev)
    e_a = jnp.where(live, e_a, s_a)
    ok &= jnp.all(jnp.where(live, s_a < e_a, True))
    nxt = jnp.concatenate([s_a[1:], jnp.full(1, 2 ** 31 - 1,
                                             jnp.int32)])
    ok &= jnp.all(jnp.where(idx < cntR - 1, e_a <= nxt, True))
    ok &= jnp.all(jnp.where(live, e_a == ends_c, True))
    return jnp.stack([s_a, e_a], axis=1), cntR, ok


# ---------------------------------------------------------------------------
# Nullable fill-in on device (general cores + UTF-8, round 5)
# ---------------------------------------------------------------------------
# FindAll(R) = FindAll(core) + empty matches at every Go rune boundary
# not covered by a core span and not equal to a core span end
# (meta/nullable.py's factorization; host twin fill_empties).  The core
# spans arrive device-resident from the core engine's own builder; the
# fill is pure device algebra: rune-boundary mask (jnp port of
# rune_boundary_mask), interval coverage via a hit-sized diff scatter +
# blocked cumsum, end rejection, one chain compaction of the empties,
# and a two-sided searchsorted merge.

def cumsum_i32_fast(x):
    """Inclusive int32 cumsum via a 2-D reshape (XLA's 1-D cumsum lowers
    to many full passes at tens of millions of elements)."""
    m = int(x.shape[0])
    C = 1024
    R = -(-m // C)
    pad = R * C - m
    if pad:
        x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
    x2 = x.reshape(R, C)
    row = jnp.cumsum(x2, axis=1)
    carry = jnp.concatenate(
        [jnp.zeros(1, x.dtype), jnp.cumsum(row[:, -1])[:-1]])
    return (row + carry[:, None]).reshape(-1)[:m]


def _rune_boundaries(dev, n: int):
    """[n+1] bool jnp twin of meta/nullable.py:rune_boundary_mask
    (callers gate n >= 4)."""
    d = dev
    T = jnp.ones(1, dtype=bool)

    def u8(v):
        return np.uint8(v)

    pad = jnp.concatenate([d, jnp.zeros(3, dtype=d.dtype)])
    cont = (pad & u8(0xC0)) == u8(0x80)
    s2 = pad[1:n + 1]
    c2, c3, c4 = cont[1:n + 1], cont[2:n + 2], cont[3:n + 3]
    two = (d >= u8(0xC2)) & (d <= u8(0xDF)) & c2
    three = (((d == u8(0xE0)) & (s2 >= u8(0xA0)) & (s2 <= u8(0xBF)))
             | ((d >= u8(0xE1)) & (d <= u8(0xEC)) & c2)
             | ((d == u8(0xED)) & (s2 >= u8(0x80)) & (s2 <= u8(0x9F)))
             | ((d >= u8(0xEE)) & (d <= u8(0xEF)) & c2)) & c3
    four = (((d == u8(0xF0)) & (s2 >= u8(0x90)) & (s2 <= u8(0xBF)))
            | ((d >= u8(0xF1)) & (d <= u8(0xF3)) & c2)
            | ((d == u8(0xF4)) & (s2 >= u8(0x80)) & (s2 <= u8(0x8F)))
            ) & c3 & c4
    ge2 = two | three | four
    ge3 = three | four
    b1 = jnp.concatenate([T, ~ge2])
    m3 = jnp.concatenate([T, T, ~ge3[:n - 1]])
    m4 = jnp.concatenate([T, T, T, ~four[:n - 2]])
    return b1 & m3 & m4


@functools.partial(jax.jit, static_argnames=("ascii_only", "nwb1"))
def nullable_fill_words(spans_c, cnt_c, dev, ascii_only: bool,
                        nwb1: int):
    """(empty-position words [nwb1] over the [n+1] domain, empty count):
    rune boundaries minus core coverage minus core ends."""
    n = int(dev.shape[0])
    capC = int(spans_c.shape[0])
    idx = jnp.arange(capC, dtype=jnp.int32)
    livec = idx < cnt_c
    BIG = jnp.int32(2 ** 30)
    S = jnp.where(livec, spans_c[:, 0], BIG)
    E = jnp.where(livec, spans_c[:, 1], BIG)
    if ascii_only:
        B = jnp.ones(n + 1, dtype=bool)
    else:
        B = _rune_boundaries(dev, n)
    diff = jnp.zeros(n + 2, dtype=jnp.int32)
    diff = diff.at[S].add(1, mode="drop", indices_are_sorted=True,
                          unique_indices=True)
    diff = diff.at[E].add(-1, mode="drop", indices_are_sorted=True,
                          unique_indices=True)
    covered = cumsum_i32_fast(diff[:n + 1]) > 0
    B = B & ~covered
    B = B.at[E].set(False, mode="drop", indices_are_sorted=True,
                    unique_indices=True)
    ne = B.sum(dtype=jnp.int32)
    return _pad_pack(B, n + 1)[:nwb1], ne


@functools.partial(jax.jit, static_argnames=("capT",))
def nullable_merge(spans_c, cnt_c, emp_pos, ne, n_dev, capT: int):
    """Interleave core spans with empty matches by position (the
    searchsorted twin of meta/nullable.py:fill_empties).  Returns
    (spans [capT,2], total)."""
    capC = int(spans_c.shape[0])
    capK = int(emp_pos.shape[0])
    INF = jnp.int32(2 ** 31 - 1)
    idxc = jnp.arange(capC, dtype=jnp.int32)
    idxk = jnp.arange(capK, dtype=jnp.int32)
    livec = idxc < cnt_c
    livek = idxk < ne
    S = jnp.where(livec, spans_c[:, 0], INF)
    E = jnp.where(livec, spans_c[:, 1], jnp.int32(0))
    emp = jnp.where(livek, emp_pos, INF)
    pos_core = idxc + jnp.searchsorted(emp, S).astype(jnp.int32)
    pos_emp = idxk + jnp.searchsorted(S, emp).astype(jnp.int32)
    pos_core = jnp.where(livec, pos_core, jnp.int32(capT + 1))
    pos_emp = jnp.where(livek, pos_emp, jnp.int32(capT + 1))
    out_s = jnp.full(capT, n_dev, dtype=jnp.int32)
    out_e = jnp.full(capT, n_dev, dtype=jnp.int32)
    out_s = out_s.at[pos_core].set(jnp.where(livec, S, 0),
                                   mode="drop")
    out_e = out_e.at[pos_core].set(E, mode="drop")
    out_s = out_s.at[pos_emp].set(jnp.where(livek, emp, 0),
                                  mode="drop")
    out_e = out_e.at[pos_emp].set(jnp.where(livek, emp, 0),
                                  mode="drop")
    total = cnt_c + ne
    liveT = jnp.arange(capT, dtype=jnp.int32) < total
    out_s = jnp.where(liveT, out_s, n_dev)
    out_e = jnp.where(liveT, out_e, out_s)
    return jnp.stack([out_s, out_e], axis=1), total


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap", "k"))
def _literal_spans_jit(words, n_dev, cap: int, k: int):
    starts, cnt, ok = sparse_positions_words(words, n_dev, cap)
    live = jnp.arange(cap, dtype=jnp.int32) < cnt
    ends = jnp.where(live, starts + k, starts)
    return jnp.stack([starts, ends], axis=1), cnt, ok


_I32_CACHE: dict = {}


def _dev_i32(n: int):
    """Cached device scalar: a fresh jnp.int32(n) per call would be a
    (possibly blocking) host-to-device transfer."""
    v = _I32_CACHE.get(n)
    if v is None:
        v = _I32_CACHE[n] = jnp.int32(n)
        if len(_I32_CACHE) > 256:
            _I32_CACHE.pop(next(iter(_I32_CACHE)))
    return v


def literal_spans_sparse(words, n: int, cap: int, k: int):
    """Chain + fixed-length ends: (spans [cap,2], cnt, ok).  `words`
    must be bucket-padded (producers are); programs cache per
    (word-bucket, cap, k), not per corpus length."""
    return _literal_spans_jit(words, _dev_i32(n), cap, k)


@functools.partial(jax.jit, static_argnames=("cap", "end_adjust"))
def _pair_spans_jit(words_s, words_e, ns_dev, ne_dev, cap: int,
                    end_adjust: int):
    starts, cs, ok1 = sparse_positions_words(words_s, ns_dev, cap)
    ends, ce, ok2 = sparse_positions_words(words_e, ne_dev, cap)
    live = jnp.arange(cap, dtype=jnp.int32) < cs
    if end_adjust:
        ends = jnp.where(live, ends + end_adjust, ends)
    ok = ok1 & ok2 & (cs == ce)
    ok &= jnp.all(jnp.where(live, starts < ends, True))
    nxt = jnp.concatenate(
        [starts[1:], jnp.full(1, 2**31 - 1, jnp.int32)])
    live_nxt = jnp.arange(cap, dtype=jnp.int32) < cs - 1
    ok &= jnp.all(jnp.where(live_nxt, ends <= nxt, True))
    ends = jnp.where(live, ends, starts)
    return jnp.stack([starts, ends], axis=1), cs, ok


def pair_spans_sparse(words_s, words_e, ns: int, ne: int,
                      cap: int, end_adjust: int = 0):
    """Two chains zipped into spans with the alignment validation of
    spans_from_masks: (spans [cap,2], cnt, ok).  ns/ne: mask domain
    sizes (emask is often [n+1]).  end_adjust is added to compacted end
    positions (charclass emask marks the LAST member, +1 makes it
    exclusive).  `words_*` must be bucket-padded (producers are)."""
    return _pair_spans_jit(words_s, words_e, _dev_i32(ns),
                           _dev_i32(ne), cap, end_adjust)
