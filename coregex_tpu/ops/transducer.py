"""Lane-parallel transducer scan: the one device kernel behind the count,
span-event and flag-reset scanners (ops/count_scan.py, span_scan.py,
flag_scan.py).

The corpus is cut into L lanes of T bytes.  Bytes are packed 4 per int32
word and laid out time-major, `words[t, lane]`, so the lanes of one
block read consecutive words.  Each lane walks its chunk through a
packed transition table

    table[s * nc + col] = delta * 32 + emit          (emit < 32)

with `col = cmap[byte]` (a 256-entry byte -> column map; the flag-reset
scanner feeds symbols that already are columns and passes no map).  The
emit bits are read per mode:

    count   emit is the number of matches the transition commits;
    events  bit 0 = candidate match end, bit 1 = first flag of a group,
            bits 2-4 = commits (span_scan.py);
    flags   bit 0 = match flag, bit 1 = reset interference (flag_scan.py).

Every lane first scans a warmup window (`warm[t, lane]`, the W-byte tail
of the previous lane) from a guessed entry state, skipping the first
`offsets[lane]` warmup bytes; the state after the warmup is `sync`, the
state at the lane end `exits`.  Bytes at or past `limits[lane]` leave
the state alone.  The callers stitch lanes exactly by rescanning the
lanes whose `sync` differs from the previous lane's exit; `active` masks
the lanes a rescan touches, and the outputs of inactive lanes keep their
previous values.

Two implementations with one contract:

  * `impl="triton"`: a Pallas kernel lowered through Triton.  One thread
    per lane, BLOCK_LANES lanes per program; the table and the byte map
    are gathered from global memory and stay in L1.
  * `impl="xla"`: the plain `lax.scan` over word steps with XLA gathers,
    the reference the kernel is tested against, and the CPU path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# (count shift, count mask, number of word-stream outputs) per mode
_MODES = {"count": (0, 31, 0), "events": (2, 7, 2), "flags": (1, 1, 1)}

BLOCK_LANES = 128
_NUM_WARPS = 4


def default_impl() -> str:
    """The Triton kernel on the GPU; the XLA scan everywhere else."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def _step_word(w, s, cnt, live_of, gather_col, gather_val, shift, mask,
               nout, accs, bit0):
    """Step the 4 bytes of word `w`; returns (state, count, accs) with
    each word-stream output's bits set at positions bit0 + k."""
    for k in range(4):
        b = (w >> (8 * k)) & 255
        val = gather_val(s, gather_col(b))
        live = live_of(k)
        if cnt is not None:
            cnt = cnt + jnp.where(live, (val >> shift) & mask, 0)
        for i in range(nout):
            bit = jnp.where(live, (val >> i) & 1, 0)
            accs[i] = accs[i] | (bit << (bit0 + k))
        s = jnp.where(live, val >> 5, s)
    return s, cnt, accs


def _kernel(*refs, mode: str, nc: int, t4: int, w4: int, has_cmap: bool):
    shift, mask, nout = _MODES[mode]
    it = iter(refs)
    table_ref = next(it)
    cmap_ref = next(it) if has_cmap else None
    entries_ref, offsets_ref, limits_ref, active_ref, warm_ref, words_ref = (
        next(it) for _ in range(6))
    word_refs = [next(it) for _ in range(nout)]
    counts_ref, exits_ref, sync_ref = next(it), next(it), next(it)

    def gather_col(b):
        return cmap_ref[b] if has_cmap else b

    def gather_val(s, c):
        return table_ref[s * nc + c]

    s = entries_ref[...]
    offs = offsets_ref[...]
    lim = limits_ref[...]
    zero = jnp.zeros_like(s)
    # a block with no active lane skips both loops (repair rounds only
    # pay for the blocks that hold a mismatched lane)
    go = jnp.minimum(jnp.max(active_ref[...]), 1)
    n_warm = go * w4
    n_main = go * (t4 // 8 if nout else t4)

    def warm_body(t, s):
        s, _, _ = _step_word(
            warm_ref[t, :], s, None, lambda k: (t * 4 + k) >= offs,
            gather_col, gather_val, shift, mask, 0, [], 0)
        return s

    s = jax.lax.fori_loop(0, n_warm, warm_body, s)
    sync_ref[...] = s

    if nout == 0:
        def body(t, carry):
            s, cnt = carry
            s, cnt, _ = _step_word(
                words_ref[t, :], s, cnt, lambda k: (t * 4 + k) < lim,
                gather_col, gather_val, shift, mask, 0, [], 0)
            return s, cnt
    else:
        # one output word per 8 input words (32 positions)
        def body(g, carry):
            s, cnt = carry
            accs = [zero] * nout
            for j in range(8):
                t = g * 8 + j
                s, cnt, accs = _step_word(
                    words_ref[t, :], s, cnt,
                    lambda k, t=t: (t * 4 + k) < lim, gather_col,
                    gather_val, shift, mask, nout, accs, 4 * j)
            for ref, acc in zip(word_refs, accs):
                ref[g, :] = acc
            return s, cnt

    s, cnt = jax.lax.fori_loop(0, n_main, body, (s, zero))
    counts_ref[...] = cnt
    exits_ref[...] = s


def _scan_triton(mode, table, cmap, entries, offsets, limits, active, warm,
                 words, nc: int, interpret: bool = False):
    t4, L = words.shape
    w4 = warm.shape[0]
    nout = _MODES[mode][2]
    bl = min(BLOCK_LANES, L)
    lane = pl.BlockSpec((bl,), lambda i: (i,))
    full = pl.BlockSpec(memory_space=None)
    has_cmap = cmap is not None
    in_specs = ([full] + ([full] if has_cmap else []) + [lane] * 4
                + [pl.BlockSpec((w4, bl), lambda i: (0, i)),
                   pl.BlockSpec((t4, bl), lambda i: (0, i))])
    out_specs = ([pl.BlockSpec((t4 // 8, bl), lambda i: (0, i))] * nout
                 + [lane] * 3)
    out_shape = ([jax.ShapeDtypeStruct((t4 // 8, L), jnp.int32)] * nout
                 + [jax.ShapeDtypeStruct((L,), jnp.int32)] * 3)
    kern = functools.partial(_kernel, mode=mode, nc=nc, t4=t4, w4=w4,
                             has_cmap=has_cmap)
    args = [table] + ([cmap] if has_cmap else []) + [
        entries, offsets, limits, active.astype(jnp.int32), warm, words]
    return pl.pallas_call(
        kern, grid=(L // bl,), in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, interpret=interpret,
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1),
        name=f"transducer_{mode}")(*args)


def _scan_xla(mode, table, cmap, entries, offsets, limits, active, warm,
              words, nc: int):
    """Plain XLA version of the kernel: a `lax.scan` over word steps."""
    del active  # computes every lane; the caller keeps inactive outputs
    shift, mask, nout = _MODES[mode]
    t4, L = words.shape

    def gather_col(b):
        return cmap[b] if cmap is not None else b

    def gather_val(s, c):
        return table[s * nc + c]

    def warm_body(s, xc):
        w, t = xc
        s, _, _ = _step_word(w, s, None, lambda k: (t * 4 + k) >= offsets,
                             gather_col, gather_val, shift, mask, 0, [], 0)
        return s, None

    sync, _ = jax.lax.scan(
        warm_body, entries,
        (warm, jnp.arange(warm.shape[0], dtype=jnp.int32)))

    def body(carry, xc):
        s, cnt = carry
        w, t = xc
        accs = [jnp.zeros_like(s)] * nout
        s, cnt, accs = _step_word(w, s, cnt, lambda k: (t * 4 + k) < limits,
                                  gather_col, gather_val, shift, mask, nout,
                                  accs, 0)
        return (s, cnt), tuple(accs)

    (exits, counts), nibbles = jax.lax.scan(
        body, (sync, jnp.zeros_like(sync)),
        (words, jnp.arange(t4, dtype=jnp.int32)))
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :, None]
    outs = [(x.reshape(t4 // 8, 8, L) << sh).sum(axis=1, dtype=jnp.int32)
            for x in nibbles]
    return (*outs, counts, exits, sync)


def scan_lanes(impl: str, mode: str, table, cmap, entries, offsets,
               limits, warm, words, nc: int, active=None, prev=None):
    """One pass of the transducer over every lane (see module doc).

    Returns (*word_streams [T4/8, L], counts [L], exits [L], sync [L]).
    With `active` given, inactive lanes take their outputs from `prev`
    (a previous result tuple of the same shape)."""
    L = words.shape[1]
    if active is None:
        active = jnp.ones((L,), bool)
    if impl == "triton":
        out = _scan_triton(mode, table, cmap, entries, offsets, limits,
                           active, warm, words, nc)
    elif impl == "xla":
        out = _scan_xla(mode, table, cmap, entries, offsets, limits,
                        active, warm, words, nc)
    else:
        raise ValueError(f"unknown transducer impl {impl!r}")
    out = tuple(out)
    if prev is None:
        return out
    return tuple(jnp.where(active[None, :] if o.ndim == 2 else active, o, p)
                 for o, p in zip(out, prev))


def stitch(impl: str, mode: str, table, cmap, entries0, offsets0, limits,
           warm, words, nc: int, first, real, W: int,
           max_repair: int = 4):
    """First pass plus the boundary-repair fixpoint.

    Lane l > 0 is exact iff its `sync` equals lane l-1's exit (both are
    states at the lane start); lane 0 is exact by construction (entry
    `first`, no warmup).  Mismatched real lanes rescan from the previous
    lane's exit with the warmup skipped, until the chain holds or
    `max_repair` rounds ran.  Returns (result tuple, converged)."""
    out = scan_lanes(impl, mode, table, cmap, entries0, offsets0, limits,
                     warm, words, nc)
    L = words.shape[1]
    skip = jnp.full((L,), W, jnp.int32)

    def want_of(exits):
        return jnp.concatenate([first[None].astype(jnp.int32), exits[:-1]])

    def bad(out):
        return real & (want_of(out[-2]) != out[-1])

    def cond(st):
        k, out = st
        return (k < max_repair) & jnp.any(bad(out))

    def rep(st):
        k, out = st
        new = scan_lanes(impl, mode, table, cmap, want_of(out[-2]), skip,
                         limits, warm, words, nc, active=bad(out),
                         prev=out)
        return k + 1, new

    _, out = jax.lax.while_loop(cond, rep, (jnp.int32(0), out))
    return out, ~jnp.any(bad(out))


def warm_window(words, W: int):
    """[W/4, L] warmup words: lane l gets the W-byte tail of lane l-1
    (lane 0 gets lane L-1's, masked by its offset)."""
    t4 = words.shape[0]
    return jnp.roll(words[t4 - W // 4:], 1, axis=1)


def positions_major(w, n):
    """[T4/8, L] lane-major word stream -> position-major words
    [L*T/32], bits at positions >= n cleared."""
    flat = w.T.reshape(-1)
    base = jnp.arange(flat.shape[0], dtype=jnp.int32) * 32
    bits = jnp.clip(n - base, 0, 32)
    pmask = jnp.where(bits >= 32, jnp.int32(-1),
                      jnp.left_shift(jnp.int32(1), jnp.minimum(bits, 31)) - 1)
    return flat & pmask


# ---------------------------------------------------------------------------
# Geometry and word layout
# ---------------------------------------------------------------------------

MAX_LANES = 1 << 17
MIN_LANES = 8
MIN_LANE_BYTES = 1024


def size_bucket(n: int) -> int:
    """Round a corpus length up to a 1/8-power-of-two bucket (<= 12.5%
    padding).  Geometries derive from the bucket, so one compiled
    executable serves every corpus size in it; per-lane `limits` keep
    the result exact."""
    if n <= 0:
        return 0
    if n <= 4096:
        step = max(64, (1 << (n.bit_length() - 1)) // 8)
        return -(-n // step) * step
    step = max(1, (1 << (n.bit_length() - 1)) // 8)
    return -(-n // step) * step


def plan_geometry(n: int, max_lanes: int = MAX_LANES,
                  min_lane_bytes: int = MIN_LANE_BYTES,
                  warmup: int = 64) -> Tuple[int, int, int]:
    """(L, T, W): L lanes (a power of two, at least MIN_LANES, at most
    `max_lanes` = ~10^5 threads in flight on a Hopper card), T bytes per
    lane (a multiple of 32: one output word per 8 input words), W warmup
    bytes (a multiple of 4, at most T).  Lanes shrink until each holds
    at least `min_lane_bytes`, so the warmup stays a small share and
    small inputs have few lane seams to repair."""
    nb = size_bucket(max(n, 1))
    L = max_lanes
    while L > MIN_LANES and L * min_lane_bytes > nb:
        L //= 2
    T = -(-nb // L)
    T = -(-T // 32) * 32
    W = max(4, (min(warmup, T) // 4) * 4)
    return L, T, W


@functools.partial(jax.jit, static_argnames=("L", "T4"))
def make_word_tiles(data_u8, L: int, T4: int):
    """[n] u8 -> time-major words [T4, L] int32: word t of lane l packs
    bytes l*T + 4t .. l*T + 4t + 3 little-endian (zero padded)."""
    pad = L * T4 * 4 - data_u8.shape[0]
    d = jnp.pad(data_u8, (0, pad))
    w = jax.lax.bitcast_convert_type(d.reshape(L * T4, 4), jnp.int32)
    return w.reshape(L, T4).T


_tiles_cache: dict = {}


def corpus_word_tiles(data_u8, L: int, T: int):
    """Word tiles cached by (buffer id, geometry).  Each entry keeps a
    strong reference to the keyed array: without it a freed array's id
    can be reused by a new corpus and serve stale tiles."""
    key = (id(data_u8), L, T)
    ent = _tiles_cache.get(key)
    if ent is None or ent[0] is not data_u8:
        ent = (data_u8, make_word_tiles(data_u8, L, T // 4))
        _tiles_cache[key] = ent
        while len(_tiles_cache) > 8:
            _tiles_cache.pop(next(iter(_tiles_cache)))
    return ent[1]


def lane_limits(n, L: int, T: int):
    return jnp.clip(n - jnp.arange(L, dtype=jnp.int32) * T, 0, T)


def first_lane_offsets(L: int, W: int):
    """Warmup offsets for a first pass: lane 0 skips its warmup (its
    entry is exact), the others scan all of it."""
    return jnp.zeros((L,), jnp.int32).at[0].set(W)
