"""Data-parallel DFA scan kernels (JAX/XLA path).

The reference's hot loop (dfa/lazy/lazy.go:602-673: one byte -> one
class -> one flat-table gather) across lanes: the corpus splits into L
lanes scanned in parallel, each lane stepping its own DFA state through
a dense transition table with one gather per byte.  Boundary-stitching
repair runs *inside* the jit (bounded lax.while_loop) and all reductions
(counts, flag positions) happen on device; only compact results move to
the host.

Exactness across chunk boundaries uses warmup-guess + fixpoint repair:
every lane first scans a W-byte warmup overlap from a guessed restart
state; lane i's scan is provably exact iff its state at the chunk start
equals lane i-1's claimed exit state, checked transitively from lane 0
(whose entry is the true start).  Mismatched lanes rescan from corrected
entries until the chain fixes (typically zero rounds); a `converged` flag
reports failure and the caller falls back to the host scan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD, DEAD, DenseDFA


def _bucket(x: int, lo: int = 8) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Device-resident DFA tables
# ---------------------------------------------------------------------------

@dataclass
class DeviceDFA:
    """DFA tables uploaded once per pattern (jnp arrays).

    Tables are *segment-expanded* (columns indexed by contiguous byte
    segments, not merged equivalence classes) so the byte -> column map is
    a searchsorted over boundaries instead of a device gather, and padded
    to power-of-two buckets so different patterns share jitted kernels.
    """
    delta: jnp.ndarray        # [S, C] int32 (segment columns)
    match_on: jnp.ndarray     # [S, C] bool
    match_eoi: jnp.ndarray    # [S, 4] bool
    starts: jnp.ndarray       # [4] int32
    bounds: jnp.ndarray       # [NB] int32 segment boundaries (sorted)
    classes: jnp.ndarray      # [256] int32 byte -> segment column (for
    #                           gather-based consumers, e.g. CPU shard path)
    num_states: int           # padded S
    num_classes: int          # padded C (segments)
    host_eoi: np.ndarray      # [S, 4] host copy (cheap EOI checks)
    host_starts: np.ndarray   # [4]

    @classmethod
    def from_dense(cls, dfa: DenseDFA) -> "DeviceDFA":
        S, C0 = dfa.delta.shape
        classes = dfa.classes  # [256]
        # segment boundaries: bytes where the class id changes
        bounds = [b for b in range(1, 256) if classes[b] != classes[b - 1]]
        nseg = len(bounds) + 1
        # segment -> class map, then expand tables to segment columns
        seg_cls = np.empty(nseg, dtype=np.int64)
        seg_starts = [0] + bounds
        for i, b in enumerate(seg_starts):
            seg_cls[i] = classes[b]
        SP, CP = _bucket(S), _bucket(nseg, 4)
        delta = np.zeros((SP, CP), dtype=np.int32)
        match = np.zeros((SP, CP), dtype=bool)
        delta[:S, :nseg] = dfa.delta[:, seg_cls]
        match[:S, :nseg] = dfa.match_on[:, seg_cls]
        match_eoi = np.zeros((SP, 4), dtype=bool)
        match_eoi[:S] = dfa.match_eoi
        # pad boundary array to a shared bucket so searchsorted shapes match
        NB = _bucket(max(len(bounds), 1), 4)
        bpad = np.full(NB, 256, dtype=np.int32)
        bpad[:len(bounds)] = bounds
        seg_of_byte = np.searchsorted(bpad, np.arange(256), side="right")
        return cls(
            delta=jnp.asarray(delta),
            match_on=jnp.asarray(match),
            match_eoi=jnp.asarray(match_eoi),
            starts=jnp.asarray(dfa.starts, dtype=jnp.int32),
            bounds=jnp.asarray(bpad),
            classes=jnp.asarray(seg_of_byte.astype(np.int32)),
            num_states=SP,
            num_classes=CP,
            host_eoi=np.asarray(dfa.match_eoi),
            host_starts=np.asarray(dfa.starts),
        )

    def classes_of(self, data: jnp.ndarray) -> jnp.ndarray:
        """Gather-free byte -> segment-column map."""
        return jnp.searchsorted(self.bounds, data.astype(jnp.int32),
                                side="right").astype(jnp.int32)


def byte_context(data: jnp.ndarray) -> jnp.ndarray:
    """Context index (CTX_*) of each byte, vectorized (for start states)."""
    is_word = ((data >= 48) & (data <= 57)) | ((data >= 65) & (data <= 90)) \
        | (data == 95) | ((data >= 97) & (data <= 122))
    is_nl = data == 10
    return jnp.where(is_word, CTX_WORD, jnp.where(is_nl, CTX_NL, CTX_OTHER))


def start_states_for(ddfa: DeviceDFA, data: jnp.ndarray,
                     starts: jnp.ndarray) -> jnp.ndarray:
    """Start state per lane given each lane's start offset (gather-free
    4-way select over the context start table)."""
    prev_b = data[jnp.maximum(starts - 1, 0)]
    ctx = byte_context(prev_b)
    ctx = jnp.where(starts == 0, CTX_SOT, ctx)
    tbl = ddfa.starts
    return jnp.where(
        ctx == CTX_SOT, tbl[CTX_SOT],
        jnp.where(ctx == CTX_WORD, tbl[CTX_WORD],
                  jnp.where(ctx == CTX_NL, tbl[CTX_NL], tbl[CTX_OTHER])))


# ---------------------------------------------------------------------------
# Transition step
# ---------------------------------------------------------------------------

def make_step():
    """step(tables, s [L], c [L]) -> (next [L], flag [L] bool): one
    gather per table."""
    def step(tables, s, c):
        delta, match_on = tables
        return delta[s, c], match_on[s, c]
    return step


# ---------------------------------------------------------------------------
# Chunked full-corpus scan (single fused jit incl. boundary repair)
# ---------------------------------------------------------------------------

def _plan_geometry(n: int, target_chunk: int = 1024, max_lanes: int = 65536,
                   warmup: int = 64) -> Tuple[int, int, int]:
    """Lane geometry for the chunked scan.  T derives from the 1/8-pow2
    size bucket (transducer.size_bucket) so one compiled executable
    serves every corpus size in the bucket (remote compiles cost
    minutes); per-lane bounds keep the result exact."""
    from .transducer import size_bucket
    if n <= 2 * target_chunk:
        return 1, size_bucket(max(n, 1)), 0
    nb = size_bucket(n)
    lanes = min(max_lanes, max(1, -(-nb // target_chunk)))
    lanes = 1 << (lanes - 1).bit_length()
    lanes = min(lanes, max_lanes)
    T = -(-nb // lanes)
    W = min(warmup, max(T // 2, 1))
    return lanes, T, W


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "W", "S", "C", "max_repair",
                     "dead_stops"))
def _chunk_scan_full(delta, match_on, starts_tbl, bounds, data,
                     sot_start, L: int, T: int, W: int, S: int, C: int, max_repair: int, dead_stops: bool = False):
    """Full-corpus scan, all inside one jit: class mapping, warmup scan,
    in-jit fixpoint repair, flag matrix.  Returns
    (flags [L, T] bool (chunk region only), exits [L], converged bool).

    dead_stops: the automaton dies after its first match (break-at-match
    DFAs): once an exactly known lane exits DEAD, every later lane is
    DEAD whatever its own scan says, so only the lanes up to it need to
    agree; later lanes report no flags and a DEAD exit."""
    n_steps = W + T
    tables = (delta, match_on)
    step = make_step()

    # classes fit a byte: keeping the corpus-length arrays u8 instead of
    # int32 cuts the class-map + warmup-concat transients from ~13 GB to
    # ~3.3 GB on a 1.6 GB corpus (indices promote at use sites)
    cls_all = jnp.searchsorted(bounds, data.astype(jnp.int32),
                               side="right").astype(jnp.uint8)
    pad = L * T - data.shape[0]
    cls_pad = jnp.pad(cls_all, (0, pad))
    chunks = cls_pad.reshape(L, T)
    if W > 0:
        warm = jnp.roll(chunks, 1, axis=0)[:, T - W:]
        xs = jnp.concatenate([warm, chunks], axis=1)
    else:
        xs = chunks
    xs_T = xs.T  # [n_steps, L]

    # guessed entries from warmup-preceding byte context
    starts_off = jnp.arange(L, dtype=jnp.int32) * T
    guess_pos = starts_off - W  # first warmup byte; context byte is -1 more
    guessed = start_states_for(
        DeviceDFAView(starts_tbl), data, jnp.maximum(guess_pos, 0))
    guessed = jnp.where(guess_pos <= 0, sot_start, guessed)
    entries0 = guessed.at[0].set(sot_start)
    offsets0 = jnp.zeros((L,), jnp.int32).at[0].set(W)

    def scan_once(entries, offsets):
        def body_w(carry, c):
            s, t = carry
            live = t >= offsets
            nxt, _ = step(tables, s, c)
            return (jnp.where(live, nxt, s), t + 1), None

        def body_m(s, c):
            nxt, flg = step(tables, s, c)
            return nxt, flg

        (sync, _), _ = jax.lax.scan(
            body_w, (entries, jnp.int32(0)), xs_T[:W], unroll=4)
        fin, flags = jax.lax.scan(body_m, sync, xs_T[W:], unroll=8)
        return fin, flags, sync

    exits0, flags0, sync0 = scan_once(entries0, offsets0)

    def want_of(exits):
        return jnp.concatenate([jnp.array([1], jnp.int32) * sot_start,
                                exits[:-1]])

    # compare the previous lane's exit against the POST-warmup state at
    # the lane start (same position): a warmup that already converged
    # the state costs no repair rescan.  Comparing the pre-warmup entry
    # guess here (the original code) made nearly every scan pay a
    # spurious full-corpus repair round.
    lane = jnp.arange(L, dtype=jnp.int32)

    def bad_of(exits, sync):
        bad = want_of(exits) != sync
        if not dead_stops:
            return bad, L
        exact = jnp.cumsum(bad.astype(jnp.int32)) == 0
        dead = exact & (exits == DEAD)
        stop = jnp.where(jnp.any(dead), jnp.argmax(dead), L)
        return bad & (lane <= stop), stop

    def cond(state):
        k, entries, exits, flags, sync = state
        return (k < max_repair) & jnp.any(bad_of(exits, sync)[0])

    def rep(state):
        k, entries, exits, flags, sync = state
        new_entries = want_of(exits)
        offs = jnp.full((L,), W, jnp.int32)
        new_exits, new_flags, new_sync = scan_once(new_entries, offs)
        return (k + 1, new_entries, new_exits, new_flags, new_sync)

    k, entries, exits, flags, sync = jax.lax.while_loop(
        cond, rep, (jnp.int32(0), entries0, exits0, flags0, sync0))
    bad, stop = bad_of(exits, sync)
    if dead_stops:
        flags = flags & (lane <= stop)[None, :]
        exits = jnp.where(lane > stop, jnp.int32(DEAD), exits)
    return flags.T, exits, ~jnp.any(bad)


class ChunkScanner:
    """Full-corpus match-flag scan with exact boundary stitching.

    `scan_device` keeps everything on device; `scan` is the host-facing
    wrapper used by tests and small inputs.
    """

    def __init__(self, ddfa: DeviceDFA, max_repair: int = 4,
                 dead_stops: bool = False):
        self.d = ddfa
        self.max_repair = max_repair
        self.dead_stops = dead_stops

    # per-launch byte cap: the single-launch scan's transpose/flag
    # buffers fail remote compilation past ~512 MB, so larger corpora
    # run as sequential segments with the exact exit state carried
    # (segment k's lane-0 entry = segment k-1's final exit — the same
    # sequential chain, split across launches)
    SEG_LIMIT = 1 << 29

    def _scan_one(self, data, sot, L, T, W):
        d = self.d
        return _chunk_scan_full(
            d.delta, d.match_on, d.starts, d.bounds, data,
            sot, L=L, T=T, W=W, S=d.num_states, C=d.num_classes, max_repair=self.max_repair,
            dead_stops=self.dead_stops)

    def scan_device(self, data: jnp.ndarray,
                    sot_start: Optional[int] = None):
        """Returns (flags_dev [L, T] bool, exits_dev [L], converged_dev,
        geometry (L, T)).  flags_dev[lane, t] == match end at offset
        lane*T + t (offsets >= n are padding and always False)."""
        d = self.d
        n = int(data.shape[0])
        sot = (d.starts[CTX_SOT] if sot_start is None
               else jnp.int32(sot_start))
        if n <= self.SEG_LIMIT:
            L, T, W = _plan_geometry(n)
            flags, exits, conv = self._scan_one(data, sot, L, T, W)
            return flags, exits, conv, (L, T)
        L, T, W = _plan_geometry(self.SEG_LIMIT)
        seg_bytes = L * T
        flags_parts, exits_parts = [], []
        conv_all = None
        entry = sot
        off = 0
        while off < n:
            end = min(n, off + seg_bytes)
            m = end - off
            if m == seg_bytes:
                Lk = L
            else:
                Lk = -(-m // T)
            flags, exits, conv = self._scan_one(
                data[off:end], entry, Lk, T, min(W, T))
            flags_parts.append(flags)
            exits_parts.append(exits)
            conv_all = conv if conv_all is None else (conv_all & conv)
            # full segments end exactly at a lane boundary: the last
            # lane's exit is the true state at offset `end`
            entry = exits[Lk - 1]
            off = end
        flags = jnp.concatenate(flags_parts, axis=0)
        exits = jnp.concatenate(exits_parts)
        return flags, exits, conv_all, (int(flags.shape[0]), T)

    def scan(self, data: jnp.ndarray, sot_start: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
        """Host-facing: (flags bool [n+1], exit_state_at_n)."""
        d = self.d
        n = int(data.shape[0])
        if n == 0:
            s0 = (int(d.host_starts[CTX_SOT]) if sot_start is None
                  else sot_start)
            return np.array([bool(d.host_eoi[s0, CTX_SOT])]), s0
        flags, exits, conv, (L, T) = self.scan_device(data, sot_start)
        conv_h = bool(jax.device_get(conv))
        if not conv_h:
            return self._host_scan(data, sot_start)
        body = np.asarray(jax.device_get(flags))
        out = np.zeros(n + 1, dtype=bool)
        out[:n] = body.reshape(-1)[:n]
        # exit state at n lives in the lane containing offset n-1; padding
        # beyond n advances the state, so recompute the tail on host
        exit_state = self._exit_at_n(data, exits, L, T, n)
        out[n] = bool(d.host_eoi[exit_state, CTX_SOT])
        return out, exit_state

    def _exit_at_n(self, data, exits, L, T, n) -> int:
        """True state at offset n: replay the last partial chunk on host."""
        d = self.d
        last_full = n // T  # lane index containing offset n (or L)
        if n % T == 0:
            idx = min(last_full, L) - 1
            return int(jax.device_get(exits[idx])) if idx >= 0 else \
                int(jax.device_get(exits[0]))
        # entry of the partial lane = exit of previous lane
        prev = int(jax.device_get(exits[last_full - 1])) if last_full > 0 \
            else None
        delta = np.asarray(jax.device_get(d.delta))
        bounds = np.asarray(jax.device_get(d.bounds))
        tail = np.asarray(jax.device_get(data[last_full * T:n]))
        s = prev if prev is not None else int(d.host_starts[CTX_SOT])
        cls = np.searchsorted(bounds, tail.astype(np.int32), side="right")
        for c in cls:
            s = delta[s, c]
        return int(s)

    def _host_scan(self, data: jnp.ndarray, sot_start: Optional[int]):
        d = self.d
        arr = np.asarray(jax.device_get(data), dtype=np.uint8)
        delta = np.asarray(jax.device_get(d.delta))
        match = np.asarray(jax.device_get(d.match_on))
        bounds = np.asarray(jax.device_get(d.bounds))
        s = (int(d.host_starts[CTX_SOT]) if sot_start is None else sot_start)
        cls = np.searchsorted(bounds, arr.astype(np.int32), side="right")
        n = len(arr)
        out = np.zeros(n + 1, dtype=bool)
        for p in range(n):
            c = cls[p]
            out[p] = match[s, c]
            s = delta[s, c]
        out[n] = bool(d.host_eoi[s, CTX_SOT])
        return out, int(s)


class DeviceDFAView:
    """Minimal view so start_states_for can work from a bare start table."""

    def __init__(self, starts):
        self.starts = starts


# ---------------------------------------------------------------------------
# Device-side flag reductions
# ---------------------------------------------------------------------------

@jax.jit
def flags_count(flags: jnp.ndarray) -> jnp.ndarray:
    return flags.sum(dtype=jnp.int32)


@jax.jit
def flags_count_upto(flags: jnp.ndarray, n) -> jnp.ndarray:
    """Count of set flags at offsets <= n.  Flags beyond n live in the
    zero-padding region: a pattern whose tail can consume NUL bytes
    would otherwise report phantom matches formed inside the padding
    (a flag at exactly n is legitimate — the delayed match ending at
    the corpus edge realizes on the first pad byte)."""
    L, T = flags.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (L, T), 0) * T + \
        jax.lax.broadcasted_iota(jnp.int32, (L, T), 1)
    return (flags & (idx <= n)).sum(dtype=jnp.int32)


@jax.jit
def flags_last(flags: jnp.ndarray, n) -> jnp.ndarray:
    """Largest set flag offset < n, or -1 (padding regions masked)."""
    L, T = flags.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (L, T), 0) * T + \
        jax.lax.broadcasted_iota(jnp.int32, (L, T), 1)
    return jnp.max(jnp.where(flags & (idx < n), idx, -1))


@functools.partial(jax.jit, static_argnames=("cap",))
def _flags_positions(flags: jnp.ndarray, n: int, cap: int):
    from .bytescan import _mask_nonzero
    return _mask_nonzero(flags.reshape(-1), cap)


def flag_positions(flags_dev: jnp.ndarray, n: int) -> np.ndarray:
    """Compact device->host extraction of set flag offsets (< n).

    Large flag matrices extract in row blocks of <=2^29 elements: a
    dense whole-matrix extraction on a GB corpus needs a corpus-sized
    int32 cumsum, which exceeds HBM in one piece (the per-block
    transient is ~2 GB)."""
    L, T = flags_dev.shape
    BLK = max(1, (1 << 29) // T)
    if L <= BLK:
        cnt = int(jax.device_get(flags_count(flags_dev)))
        if cnt == 0:
            return np.empty(0, dtype=np.int64)
        cap = _bucket(cnt, 16)
        idx = np.asarray(jax.device_get(
            _flags_positions(flags_dev, n, cap)))[:cnt]
        return idx[idx < n].astype(np.int64)
    parts = []
    for r0 in range(0, L, BLK):
        blk = flags_dev[r0:r0 + BLK]
        sub = flag_positions(blk, min(max(n - r0 * T, 0),
                                      int(blk.shape[0]) * T))
        if len(sub):
            parts.append(sub + r0 * T)
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Batched anchored window scan (candidate verification)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("B", "W", "S", "C"))
def _window_scan(delta, match_on, match_eoi, starts_tbl, bounds, data,
                 starts, n, B: int, W: int, S: int, C: int):
    """Anchored scan of W bytes from each of B start offsets.

    Returns (last_end [B] int32 global end offset or -1,
             alive [B] bool — state still live at window end inside text)."""
    tables = (delta, match_on)
    step = make_step()
    state = start_states_for(DeviceDFAView(starts_tbl), data, starts)

    idx = starts[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    in_text = idx < n
    bytes_w = data[jnp.minimum(idx, n - 1)]
    cls_w = jnp.searchsorted(bounds, bytes_w.astype(jnp.int32),
                             side="right").astype(jnp.int32)

    eoi_sot = match_eoi[:, CTX_SOT]

    def body(carry, xc):
        st, last = carry
        c, valid, pos = xc
        nxt, flg = step(tables, st, c)
        at_eoi = ~valid & (pos == n) & (st != DEAD)
        # EOI flag via one-hot over states (gather-free)
        oh = st[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
        eoi_flag = jnp.sum(jnp.where(oh, eoi_sot[None, :], False),
                           axis=1) & at_eoi
        flag = (flg & valid) | eoi_flag
        last = jnp.where(flag, pos, last)
        nxt = jnp.where(valid, nxt, DEAD)
        return (nxt, last), None

    (fin_state, last), _ = jax.lax.scan(
        body, (state, jnp.full((B,), -1, jnp.int32)),
        (cls_w.T, in_text.T, idx.T), unroll=4)
    end_pos = starts + W
    oh = fin_state[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    eoi_fin = jnp.sum(jnp.where(oh, eoi_sot[None, :], False), axis=1)
    at_eoi_end = (end_pos == n) & (fin_state != DEAD)
    last = jnp.where(eoi_fin & at_eoi_end, end_pos, last)
    alive = (fin_state != DEAD) & (end_pos < n)
    return last, alive


class WindowScanner:
    """Batched anchored verification: leftmost-first end from each start
    (anchored_last_end analogue), with geometric window escalation."""

    def __init__(self, ddfa: DeviceDFA, init_window: int = 64,
                 max_window: int = 1 << 22):
        self.d = ddfa
        self.init_window = init_window
        self.max_window = max_window

    def _scan_round(self, data, starts_dev, n, B, W):
        d = self.d
        return _window_scan(
            d.delta, d.match_on, d.match_eoi, d.starts,
            d.bounds, data, starts_dev, jnp.int32(n),
            B=B, W=min(W, n + 1), S=d.num_states, C=d.num_classes)

    # per-launch lane cap: window scans over millions of candidates run
    # as a sequence of bounded launches — giant one-shot [B, W] shapes
    # have failed remote compilation and spike HBM
    MAX_LANES = 1 << 19

    def ends_for_starts(self, data: jnp.ndarray, starts: np.ndarray
                        ) -> np.ndarray:
        n = int(data.shape[0])
        if len(starts) == 0:
            return np.empty(0, dtype=np.int64)
        ends = np.full(len(starts), -1, dtype=np.int64)
        todo = np.arange(len(starts))
        W = self.init_window
        cur_starts = np.asarray(starts, dtype=np.int64)
        while len(todo):
            nxt_parts = []
            for off in range(0, len(todo), self.MAX_LANES):
                batch = todo[off:off + self.MAX_LANES]
                B = _bucket(len(batch), 16)
                sb = np.full(B, n, dtype=np.int32)
                sb[:len(batch)] = cur_starts[batch]
                last, alive = self._scan_round(data, jnp.asarray(sb), n,
                                               B, W)
                last = np.asarray(jax.device_get(last))[:len(batch)]
                alive = np.asarray(jax.device_get(alive))[:len(batch)]
                ends[batch] = last
                still = alive & (W < self.max_window) & (W <= n)
                nxt_parts.append(batch[still])
            todo = np.concatenate(nxt_parts) if nxt_parts else \
                np.empty(0, dtype=np.int64)
            W *= 4
        return ends

    def ends_for_starts_device(self, data: jnp.ndarray,
                               starts_dev: jnp.ndarray,
                               nvalid: int) -> jnp.ndarray:
        """Device-resident variant: `starts_dev` is a padded [B] array
        (padding entries == n, which yield end == -1); returns a device
        ends array aligned with it.  Escalation compacts alive lanes on
        device; only small scalars sync."""
        n = int(data.shape[0])
        B = int(starts_dev.shape[0])
        W = self.init_window
        ends, alive = self._scan_round(data, starts_dev, n, B, W)
        while W < self.max_window and W <= n:
            n_alive = int(jax.device_get(alive.sum(dtype=jnp.int32)))
            if n_alive == 0:
                break
            W *= 4
            cap = _bucket(n_alive, 16)
            from .bytescan import _mask_nonzero
            todo = jnp.minimum(_mask_nonzero(alive, cap), B - 1)
            sub_starts = jnp.where(
                jnp.arange(cap) < n_alive, starts_dev[todo], n)
            last2, alive2 = self._scan_round(
                data, sub_starts.astype(jnp.int32), n, cap, W)
            keep = jnp.arange(cap) < n_alive
            ends = ends.at[todo].set(
                jnp.where(keep, last2, ends[todo]))
            new_alive = jnp.zeros_like(alive).at[todo].set(alive2 & keep)
            alive = new_alive
        return ends


# ---------------------------------------------------------------------------
# Flag-bitmap window scan (reverse start discovery)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("B", "W", "S", "C"))
def _window_scan_flags(delta, match_on, match_eoi, starts_tbl, bounds,
                       data, starts, n, edge_limit,
                       B: int, W: int, S: int, C: int):
    """Like _window_scan but returns the full per-position flag bitmap
    [B, W+1] plus alive.  edge_limit bounds each lane (window-edge context
    from the byte at that position)."""
    tables = (delta, match_on)
    step = make_step()
    state = start_states_for(DeviceDFAView(starts_tbl), data, starts)

    idx = starts[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = (idx < n) & (idx < edge_limit[:, None])
    bytes_w = data[jnp.minimum(idx, n - 1)]
    cls_w = jnp.searchsorted(bounds, bytes_w.astype(jnp.int32),
                             side="right").astype(jnp.int32)

    cut = jnp.minimum(edge_limit, n)
    cut_b = data[jnp.minimum(cut, n - 1)]
    cut_ctx = jnp.where(cut >= n, CTX_SOT, byte_context(cut_b))
    # per-lane EOI row, context pre-selected per lane (gather-free)
    eoi_f = match_eoi.astype(jnp.float32)                        # [S, 4]
    ctx_oh = (cut_ctx[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, 4), 1)).astype(jnp.float32)               # [B, 4]
    # 0/1 operands, one nonzero term per sum: exact at any precision
    eoi_rows = jnp.dot(ctx_oh, eoi_f.T,
                       preferred_element_type=jnp.float32)       # [B, S]

    def eoi_of(st):
        oh = (st[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (1, S), 1))
        return jnp.sum(jnp.where(oh, eoi_rows, 0.0), axis=1) > 0.5

    def body(carry, xc):
        st = carry
        c, v, pos = xc
        nxt, flg = step(tables, st, c)
        at_cut = ~v & (pos == cut) & (st != DEAD)
        flag = (flg & v) | (eoi_of(st) & at_cut)
        nxt = jnp.where(v, nxt, DEAD)
        return nxt, flag

    fin_state, flags = jax.lax.scan(
        body, state, (cls_w.T, valid.T, idx.T), unroll=4)
    end_pos = starts + W
    at_cut_end = (end_pos == cut) & (fin_state != DEAD)
    edge_flag = eoi_of(fin_state) & at_cut_end
    alive = (fin_state != DEAD) & (end_pos < cut)
    return jnp.concatenate([flags.T, edge_flag[:, None]], axis=1), alive


# ---------------------------------------------------------------------------
# Reset scan: anchored runs restarted at marked positions (one contiguous
# pass — the gather-free replacement for per-candidate window scans)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "W", "S", "C", "max_repair"))
def _chunk_scan_reset(delta, match_on, starts_tbl, bounds, data,
                      aux, sot_start, L: int, T: int, W: int, S: int,
                      C: int, max_repair: int):
    """Like _chunk_scan_full, but the automaton state RESETS to the
    anchored start state at every marked position before consuming its
    byte: one contiguous lane-chunked pass computes the anchored run
    from every reset point (per-candidate verification without the
    ~70 ns/byte device gathers of windowed scans).

    aux[p] (uint8): bit0 = reset at p, bits 1-2 = CTX_* context for the
    start state (context of byte p-1).  Returns (flags [L, T], exits
    [L], converged, interfered) — interfered is True when any reset hit
    a still-live state (the previous run's extent may be cut short; the
    caller must repair or fall back)."""
    tables = (delta, match_on)
    step = make_step()

    cls_all = jnp.searchsorted(bounds, data.astype(jnp.int32),
                               side="right").astype(jnp.uint8)
    pad = L * T - data.shape[0]
    packed = (cls_all << 3) | aux  # C <= 32 gate enforced by the caller
    chunks = jnp.pad(packed, (0, pad)).reshape(L, T)
    if W > 0:
        warm = jnp.roll(chunks, 1, axis=0)[:, T - W:]
        xs = jnp.concatenate([warm, chunks], axis=1)
    else:
        xs = chunks
    xs_T = xs.T  # [n_steps, L]

    def sel_start(ctx):
        return jnp.where(
            ctx == CTX_SOT, starts_tbl[CTX_SOT],
            jnp.where(ctx == CTX_WORD, starts_tbl[CTX_WORD],
                      jnp.where(ctx == CTX_NL, starts_tbl[CTX_NL],
                                starts_tbl[CTX_OTHER])))

    def unpack(x):
        xi = x.astype(jnp.int32)
        return xi >> 3, xi & 1, (xi >> 1) & 3  # class, reset, ctx

    starts_off = jnp.arange(L, dtype=jnp.int32) * T
    guess_pos = starts_off - W
    # entry guess: resets resync quickly; DEAD (no live run) is the
    # natural guess for a reset-scan lane entry
    entries0 = jnp.full((L,), DEAD, jnp.int32).at[0].set(sot_start)
    offsets0 = jnp.zeros((L,), jnp.int32).at[0].set(W)

    def scan_once(entries, offsets):
        def body_w(carry, x):
            s, t = carry
            c, rs, ctx = unpack(x)
            live = t >= offsets
            s_pre = jnp.where(rs == 1, sel_start(ctx), s)
            nxt, _ = step(tables, s_pre, c)
            return (jnp.where(live, nxt, s), t + 1), None

        def body_m(s, x):
            c, rs, ctx = unpack(x)
            interf = (rs == 1) & (s != DEAD)
            s_pre = jnp.where(rs == 1, sel_start(ctx), s)
            nxt, flg = step(tables, s_pre, c)
            return nxt, (flg, interf)

        (sync, _), _ = jax.lax.scan(
            body_w, (entries, jnp.int32(0)), xs_T[:W], unroll=4)
        fin, (flags, interf) = jax.lax.scan(body_m, sync, xs_T[W:],
                                            unroll=8)
        return fin, flags, interf, sync

    exits0, flags0, interf0, sync0 = scan_once(entries0, offsets0)

    def want_of(exits):
        return jnp.concatenate([jnp.array([1], jnp.int32) * sot_start,
                                exits[:-1]])

    def cond(state):
        k, exits, flags, interf, sync = state
        return (k < max_repair) & jnp.any(want_of(exits) != sync)

    def rep(state):
        k, exits, flags, interf, sync = state
        new_entries = want_of(exits)
        offs = jnp.full((L,), W, jnp.int32)
        ne, nf, ni, ns = scan_once(new_entries, offs)
        return (k + 1, ne, nf, ni, ns)

    k, exits, flags, interf, sync = jax.lax.while_loop(
        cond, rep, (jnp.int32(0), exits0, flags0, interf0, sync0))
    converged = ~jnp.any(want_of(exits) != sync)
    n = data.shape[0]
    pos = (jax.lax.broadcasted_iota(jnp.int32, (T, L), 1) * T
           + jax.lax.broadcasted_iota(jnp.int32, (T, L), 0))
    interfered = jnp.any(interf & (pos < n))
    return flags.T, exits, converged, interfered


class ResetScanner:
    """Contiguous anchored-run scan with per-position restarts.

    The verification engine for candidate families: where the window
    scanner gathers a [B, W] byte matrix per batch (memory-latency
    bound), this streams the corpus once in lane chunks and restarts
    the anchored automaton at each candidate (reset) position, so ends
    come out at full scan bandwidth.  sot_start defaults to DEAD (no
    live run before the first reset)."""

    SEG_LIMIT = 1 << 29

    def __init__(self, ddfa: DeviceDFA, max_repair: int = 4):
        self.d = ddfa
        self.max_repair = max_repair
        if ddfa.num_classes > 32:
            raise ValueError("reset scan packs class+aux in u8: C <= 32")

    def _aux(self, data, reset_mask):
        prev = jnp.concatenate(
            [jnp.zeros(1, dtype=data.dtype), data[:-1]])
        ctx = byte_context(prev).astype(jnp.uint8)
        ctx = jnp.where(jnp.arange(data.shape[0]) == 0,
                        jnp.uint8(CTX_SOT), ctx)
        return (reset_mask.astype(jnp.uint8)
                | (ctx << 1)).astype(jnp.uint8)

    def _scan_one(self, data, aux, entry, L, T, W):
        d = self.d
        return _chunk_scan_reset(
            d.delta, d.match_on, d.starts, d.bounds, data, aux,
            entry, L=L, T=T, W=W, S=d.num_states, C=d.num_classes, max_repair=self.max_repair)

    def scan_device(self, data: jnp.ndarray, reset_mask: jnp.ndarray):
        """(flags [L,T], exits [L], converged, interfered, (L, T));
        flags[lane, t] == anchored-run match end at offset lane*T + t."""
        n = int(data.shape[0])
        aux = self._aux(data, reset_mask)
        entry = jnp.int32(DEAD)
        # wide warmup: a reset inside the warmup window syncs the lane
        # exactly, so candidate spacing < W makes repair rescans rare
        if n <= self.SEG_LIMIT:
            L, T, W = _plan_geometry(n, warmup=1024)
            fl, ex, cv, inf = self._scan_one(data, aux, entry, L, T, W)
            return fl, ex, cv, inf, (L, T)
        L, T, W = _plan_geometry(self.SEG_LIMIT, warmup=1024)
        seg = L * T
        fps, eps = [], []
        cv_all = None
        inf_all = None
        off = 0
        while off < n:
            end = min(n, off + seg)
            m = end - off
            Lk = L if m == seg else -(-m // T)
            fl, ex, cv, inf = self._scan_one(
                data[off:end], aux[off:end], entry, Lk, T, min(W, T))
            fps.append(fl)
            eps.append(ex)
            cv_all = cv if cv_all is None else (cv_all & cv)
            inf_all = inf if inf_all is None else (inf_all | inf)
            entry = ex[Lk - 1]
            off = end
        fl = jnp.concatenate(fps, axis=0)
        ex = jnp.concatenate(eps)
        return fl, ex, cv_all, inf_all, (int(fl.shape[0]), T)
