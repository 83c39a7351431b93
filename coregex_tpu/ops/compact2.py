"""Output-sensitive stream compaction with payload routing.

Generalizes ops/compact.py two ways, both aimed at making span
extraction cost scale with MATCHES instead of corpus size (the
reference's extraction cost is just its scan plus an append,
meta/findall.go:176-283):

1. PAYLOAD ROUTING: `compact_pay` carries int32 payload arrays through
   the same rank scatter as the positions, so "compact these VALUES
   where mask" is one pass (the building block of the sparse chain
   below and of span assembly from flag+value streams).

2. SPARSE CHAIN: set-bit extraction in n/32 + ~12*hits work instead of
   n.  The mask is packed to 32-bit words; nonzero WORDS are compacted
   with their values as payload (domain n/32); each word expands to its
   nonzero BYTES (domain 4*Kw <= 4*hits); each byte expands to its set
   bits (domain 8*Kb <= 8*hits).  Every stage is the same payload
   compaction, so the chain is exact and ordered.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _compact_pay_xla(mask8, pays, cap: int, n_sent: int):
    """(pos, *pays, cnt, ok): cumsum ranks, one scatter per output."""
    n = mask8.shape[0]
    m = mask8 != 0
    cum = jnp.cumsum(m.astype(jnp.int32))
    cnt = cum[-1] if n else jnp.int32(0)
    idx = jnp.where(m, cum - 1, cap)
    out = jnp.full(cap, n_sent, dtype=jnp.int32)
    out = out.at[idx].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    pouts = []
    for p in pays:
        po = jnp.zeros(cap, dtype=jnp.int32)
        pouts.append(po.at[idx].set(p, mode="drop"))
    live = jnp.arange(cap, dtype=jnp.int32) < cnt
    out = jnp.where(live, out, jnp.int32(n_sent))
    pouts = [jnp.where(live, p, 0) for p in pouts]
    return (out, *pouts, cnt, cnt <= cap)


@functools.partial(jax.jit, static_argnames=("cap", "n_sent"))
def _compact_pay_xla_jit(mask8, pays, cap: int, n_sent: int):
    return _compact_pay_xla(mask8, pays, cap, n_sent)


def compact_pay(mask, pays=(), cap: int = 16):
    """Positions of set entries of 1-D `mask` (ascending, int32[cap]
    padded with the sentinel n) plus each payload array compacted by the
    same permutation.  Returns (pos, *pays, cnt, ok) — all device; ok
    is False when cnt exceeded cap (results truncated)."""
    n = int(mask.shape[0])
    npay = len(pays)
    if n == 0:
        z = jnp.zeros(cap, jnp.int32)
        return (z, *[z] * npay, jnp.int32(0), jnp.bool_(True))
    pays = tuple(p.astype(jnp.int32) for p in pays)
    return _compact_pay_xla_jit(mask.astype(jnp.int8), pays, cap, n)


# ---------------------------------------------------------------------------
# Sparse chain: mask -> words -> bytes -> bit positions
# ---------------------------------------------------------------------------

def pack_words(mask, nw: int):
    """bool/int8 mask [nw*32] -> int32 words [nw], bit j = mask[32i+j].
    The bits are distinct, so the sum is their OR (bit 31 wraps to the
    sign bit).  Call INSIDE the jit that produces the mask where
    possible."""
    b = (mask.reshape(nw, 32) != 0).astype(jnp.int32)
    return (b << jnp.arange(32, dtype=jnp.int32)).sum(axis=1,
                                                       dtype=jnp.int32)


def _chain_body(words, n_dev, cap: int):
    """words[nwb] -> (pos[cap], cnt, ok): the 3-level sparse chain.
    Traced inside one jit (caps static, the sentinel value n dynamic)
    -> one dispatch."""
    nwb = int(words.shape[0])
    capw = min(nwb, cap)
    wpos, wval, cntw, ok1 = compact_pay(
        (words != 0), [words], capw)
    capb = min(4 * capw, cap)
    live = (jnp.arange(capw, dtype=jnp.int32) < cntw)[:, None]
    j4 = jax.lax.broadcasted_iota(jnp.int32, (capw, 4), 1)
    bval = (wval[:, None] >> (8 * j4)) & 0xFF
    m2 = live & (bval != 0)
    base2 = wpos[:, None] * 32 + 8 * j4
    _, bval_c, bbase_c, cntb, ok2 = compact_pay(
        m2.reshape(-1), [bval.reshape(-1), base2.reshape(-1)], capb)
    live3 = (jnp.arange(capb, dtype=jnp.int32) < cntb)[:, None]
    j8 = jax.lax.broadcasted_iota(jnp.int32, (capb, 8), 1)
    m3 = live3 & (((bval_c[:, None] >> j8) & 1) != 0)
    pos3 = bbase_c[:, None] + j8
    _, pos, cnt, ok3 = compact_pay(
        m3.reshape(-1), [pos3.reshape(-1)], cap)
    live_o = jnp.arange(cap, dtype=jnp.int32) < cnt
    pos = jnp.where(live_o, pos, n_dev.astype(jnp.int32))
    return pos, cnt, ok1 & ok2 & ok3


def _bucket_up(x: int, lo: int = 1024) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=("nwb", "cap"))
def _chain_jit(words_padded, n_dev, nwb: int, cap: int):
    return _chain_body(words_padded, n_dev, cap)


def sparse_positions_words(words, n: int, cap: int):
    """Set-bit positions from PRE-PACKED words (see pack_words) in
    nw + ~12*cap kernel work: one fused dispatch.  `cap` MUST bound the
    true hit count (ok=False + truncation otherwise).  Returns
    (pos[cap] int32, sentinel n beyond cnt; cnt; ok).

    Program-cache hygiene: the word domain is PADDED to a power-of-two
    bucket and the sentinel n is a runtime scalar, so distinct corpus
    lengths share one compiled chain per (bucket, cap) pair instead of
    compiling per exact length (the full CPU suite once exhausted
    process mmaps from per-length LLVM executables).

    Safe to call inside another jit (n may be a tracer)."""
    nw = int(words.shape[0])
    nwb = _bucket_up(max(nw, 1))
    if nwb != nw:
        words = jnp.concatenate(
            [words, jnp.zeros(nwb - nw, dtype=jnp.int32)])
    return _chain_jit(words, jnp.asarray(n, dtype=jnp.int32), nwb, cap)


def _events_body(union, kinds, n_dev, cap: int):
    """union[nwb] + per-kind words -> (pos[cap], kind[cap], cnt, ok):
    the sparse chain carrying a kind BITMASK per event.  kind bit j of
    an event = mask j had the bit.  K <= 4 kinds ride as L1 payloads;
    at the byte level they pack into ONE int32 (4 kind-bytes), so L1.5
    and L2 stay at <= 3 payloads."""
    K = len(kinds)
    assert 1 <= K <= 4
    nwb = int(union.shape[0])
    capw = min(nwb, cap)
    out1 = compact_pay((union != 0), [union] + list(kinds), capw)
    wpos, wu = out1[0], out1[1]
    wk = out1[2:2 + K]
    cntw = out1[2 + K]
    ok1 = out1[3 + K]
    capb = min(4 * capw, cap)
    live = (jnp.arange(capw, dtype=jnp.int32) < cntw)[:, None]
    j4 = jax.lax.broadcasted_iota(jnp.int32, (capw, 4), 1)
    bu = (wu[:, None] >> (8 * j4)) & 0xFF
    m2 = live & (bu != 0)
    base2 = wpos[:, None] * 32 + 8 * j4
    # pack the K kind-bytes of each byte-slot into one int32
    kpack = jnp.zeros((capw, 4), dtype=jnp.int32)
    for kk in range(K):
        kb = (wk[kk][:, None] >> (8 * j4)) & 0xFF
        kpack = kpack | (kb << (8 * kk))
    out2 = compact_pay(
        m2.reshape(-1),
        [bu.reshape(-1), base2.reshape(-1), kpack.reshape(-1)], capb)
    bu_c, bbase_c, kpack_c, cntb, ok2 = out2[1], out2[2], out2[3], \
        out2[4], out2[5]
    live3 = (jnp.arange(capb, dtype=jnp.int32) < cntb)[:, None]
    j8 = jax.lax.broadcasted_iota(jnp.int32, (capb, 8), 1)
    m3 = live3 & (((bu_c[:, None] >> j8) & 1) != 0)
    pos3 = bbase_c[:, None] + j8
    kind3 = jnp.zeros((capb, 8), dtype=jnp.int32)
    for kk in range(K):
        kb = (kpack_c[:, None] >> (8 * kk)) & 0xFF
        kind3 = kind3 | (((kb >> j8) & 1) << kk)
    out3 = compact_pay(
        m3.reshape(-1), [pos3.reshape(-1), kind3.reshape(-1)], cap)
    pos, kind, cnt, ok3 = out3[1], out3[2], out3[3], out3[4]
    live_o = jnp.arange(cap, dtype=jnp.int32) < cnt
    pos = jnp.where(live_o, pos, n_dev.astype(jnp.int32))
    return pos, kind, cnt, ok1 & ok2 & ok3


@functools.partial(jax.jit, static_argnames=("nwb", "cap"))
def _events_jit(union, kinds, n_dev, nwb: int, cap: int):
    return _events_body(union, list(kinds), n_dev, cap)


def sparse_events_words(kind_words, n: int, cap: int):
    """Position-ordered EVENT STREAM from K <= 4 word-packed masks:
    (pos[cap] ascending with sentinel n, kind[cap] bitmask of which
    masks fired, cnt, ok).  The building block of the event-stream span
    engines: per-line / per-candidate logic then runs as hit-sized
    array algebra with no corpus-sized intermediates and no gathers.
    `cap` MUST bound the total number of event positions (union bits).
    Safe inside jit."""
    kinds = [k for k in kind_words]
    union = kinds[0]
    for k in kinds[1:]:
        union = union | k
    nw = int(union.shape[0])
    nwb = _bucket_up(max(nw, 1))
    if nwb != nw:
        pad = jnp.zeros(nwb - nw, dtype=jnp.int32)
        union = jnp.concatenate([union, pad])
        kinds = [jnp.concatenate([k, pad]) for k in kinds]
    return _events_jit(union, tuple(kinds),
                       jnp.asarray(n, dtype=jnp.int32), nwb, cap)


def _chain_pay_body(evw, wordpays, n_dev, cap: int):
    """Event words + P per-WORD int32 payload arrays -> (pos[cap],
    pay0[cap], ..., cnt, ok): every event inherits its word's payload
    values.  The trick that makes per-candidate lookups gather-free:
    any precomputed per-word table (member bits, running maxima, ...)
    rides the chain and arrives aligned with the compacted events."""
    P = len(wordpays)
    nwb = int(evw.shape[0])
    capw = min(nwb, cap)
    out1 = compact_pay((evw != 0), [evw] + list(wordpays), capw)
    wpos, wu = out1[0], out1[1]
    wp = out1[2:2 + P]
    cntw, ok1 = out1[2 + P], out1[3 + P]
    capb = min(4 * capw, cap)
    live = (jnp.arange(capw, dtype=jnp.int32) < cntw)[:, None]
    j4 = jax.lax.broadcasted_iota(jnp.int32, (capw, 4), 1)
    bu = (wu[:, None] >> (8 * j4)) & 0xFF
    m2 = live & (bu != 0)
    base2 = wpos[:, None] * 32 + 8 * j4
    bc = jnp.broadcast_to
    out2 = compact_pay(
        m2.reshape(-1),
        [bu.reshape(-1), base2.reshape(-1)]
        + [bc(p[:, None], (capw, 4)).reshape(-1) for p in wp],
        capb)
    bu_c, bbase_c = out2[1], out2[2]
    wp_c = out2[3:3 + P]
    cntb, ok2 = out2[3 + P], out2[4 + P]
    live3 = (jnp.arange(capb, dtype=jnp.int32) < cntb)[:, None]
    j8 = jax.lax.broadcasted_iota(jnp.int32, (capb, 8), 1)
    m3 = live3 & (((bu_c[:, None] >> j8) & 1) != 0)
    pos3 = bbase_c[:, None] + j8
    out3 = compact_pay(
        m3.reshape(-1),
        [pos3.reshape(-1)]
        + [bc(p[:, None], (capb, 8)).reshape(-1) for p in wp_c], cap)
    pos = out3[1]
    pays = out3[2:2 + P]
    cnt, ok3 = out3[2 + P], out3[3 + P]
    live_o = jnp.arange(cap, dtype=jnp.int32) < cnt
    pos = jnp.where(live_o, pos, n_dev.astype(jnp.int32))
    return (pos, *pays, cnt, ok1 & ok2 & ok3)


@functools.partial(jax.jit, static_argnames=("nwb", "cap"))
def _chain_pay_jit(evw, wordpays, n_dev, nwb: int, cap: int):
    return _chain_pay_body(evw, list(wordpays), n_dev, cap)


def sparse_chain_payloads(event_words, word_payloads, n: int, cap: int):
    """Compact event positions from word-packed `event_words` along
    with, per event, the value of each [nw] int32 payload array at the
    event's WORD.  Returns (pos[cap], pay0[cap], ..., cnt, ok).
    Safe inside jit; inputs padded to the word bucket here."""
    evw = event_words
    pays = list(word_payloads)
    nw = int(evw.shape[0])
    nwb = _bucket_up(max(nw, 1))
    if nwb != nw:
        zpad = jnp.zeros(nwb - nw, dtype=jnp.int32)
        evw = jnp.concatenate([evw, zpad])
        pays = [jnp.concatenate([p.astype(jnp.int32), zpad])
                for p in pays]
    else:
        pays = [p.astype(jnp.int32) for p in pays]
    return _chain_pay_jit(evw, tuple(pays),
                          jnp.asarray(n, dtype=jnp.int32), nwb, cap)


def sparse_positions(mask, cap: int):
    """As sparse_positions_words but from a 1-D bool/int8 mask (packs
    words itself — callers that jit their mask production should call
    pack_words inside it and use sparse_positions_words)."""
    n = int(mask.shape[0])
    if n == 0 or cap <= 0:
        return jnp.zeros(max(cap, 1), jnp.int32), jnp.int32(0), \
            jnp.bool_(True)
    nw = -(-n // 32)
    mask8 = mask.astype(jnp.int8)
    pad = nw * 32 - n
    if pad:
        mask8 = jnp.concatenate([mask8, jnp.zeros(pad, dtype=jnp.int8)])
    words = _pack_jit(mask8, nw)
    return sparse_positions_words(words, n, cap)


@functools.partial(jax.jit, static_argnames=("nw",))
def _pack_jit(mask8, nw: int):
    return pack_words(mask8, nw)


# density threshold: chain work n/32 + 12h vs dense n  =>  h/n ~ 1/13;
# headroom for the glue passes puts the crossover nearer 1/20
SPARSE_DENSITY = 1.0 / 20


def positions_auto(mask, cap: int, nhits_hint=None):
    """compact via the sparse chain when the expected density is low,
    the single-level compaction otherwise.  nhits_hint: expected hit
    count (host int) — callers usually know it from a count sync;
    defaults to assuming dense."""
    n = int(mask.shape[0])
    if nhits_hint is not None and n > 0 and nhits_hint / n < SPARSE_DENSITY:
        return sparse_positions(mask, cap)
    pos, cnt, ok = compact_pay(mask, (), cap)
    return pos, cnt, ok
