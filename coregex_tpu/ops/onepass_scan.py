"""Batched OnePass capture extraction — the device form of the reference's
OnePass DFA search (dfa/onepass/onepass.go:33-93, search.go).

Where the reference walks one span at a time applying per-transition slot
masks, this kernel walks B spans in parallel lanes: one [B, W] window scan
whose per-byte step is the gather-free onehot formulation of
ops/dfa_scan.make_step, extended with two 16-bit slot-mask channels (the
mask must round-trip a float32 matmul exactly, so it is split at bit 16;
num_slots <= 32 == the builder's MAX_SLOTS).

Output: slots [B, NS] int32 (capture positions, -1 == unset) + ok [B] bool.
Lanes that die or end in a non-match state report ok=False and the caller
re-extracts those spans on host (graceful degradation, never wrong).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dfa.onepass import OnePassDFA


def _bucket(x: int, lo: int = 8) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


class DeviceOnePass:
    """OnePass tables uploaded once, segment-expanded and padded.

    comb [S, 3C + 4] float32 columns:
      [0:C)     delta (dead row == S-1 sentinel)
      [C:2C)    slot-mask low 16 bits
      [2C:3C)   slot-mask high 16 bits
      [3C]      match_cond
      [3C+1]    match_slots low 16
      [3C+2]    match_slots high 16
      [3C+3]    zero pad
    """

    def __init__(self, op: OnePassDFA):
        S0, C0 = op.delta.shape
        classes = op.classes
        bounds = [b for b in range(1, 256) if classes[b] != classes[b - 1]]
        seg_starts = [0] + bounds
        seg_cls = np.array([classes[b] for b in seg_starts], dtype=np.int64)
        nseg = len(seg_starts)
        SP, CP = _bucket(S0 + 1), _bucket(nseg, 4)
        dead = SP - 1
        delta = np.full((SP, CP), dead, dtype=np.int64)
        mlo = np.zeros((SP, CP), dtype=np.int64)
        mhi = np.zeros((SP, CP), dtype=np.int64)
        d_seg = op.delta[:, seg_cls].astype(np.int64)
        m_seg = op.slotmask[:, seg_cls].astype(np.int64)
        delta[:S0, :nseg] = np.where(d_seg < 0, dead, d_seg)
        mlo[:S0, :nseg] = m_seg & 0xFFFF
        mhi[:S0, :nseg] = m_seg >> 16
        tail = np.zeros((SP, 4), dtype=np.float32)
        tail[:S0, 0] = op.match_cond.astype(np.float32)
        tail[:S0, 1] = (op.match_slots.astype(np.int64) & 0xFFFF)
        tail[:S0, 2] = (op.match_slots.astype(np.int64) >> 16)
        comb = np.concatenate(
            [delta.astype(np.float32), mlo.astype(np.float32),
             mhi.astype(np.float32), tail], axis=1)
        NB = _bucket(max(len(bounds), 1), 4)
        bpad = np.full(NB, 256, dtype=np.int32)
        bpad[:len(bounds)] = bounds
        self.comb = jnp.asarray(comb)
        self.bounds = jnp.asarray(bpad)
        self.S = SP
        self.C = CP
        self.dead = dead
        self.start = int(op.start)
        self.num_slots = int(op.num_slots)


@functools.partial(jax.jit,
                   static_argnames=("B", "W", "S", "C", "NS", "start"))
def _onepass_window(comb, bounds, data, starts, ends,
                    B: int, W: int, S: int, C: int, NS: int, start: int):
    """Walk B spans of width <= W; returns (slots [B, NS] i32, ok [B])."""
    n = data.shape[0]
    idx = starts[:, None] + jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    bytes_w = data[jnp.minimum(idx, n - 1)]
    cls_w = jnp.searchsorted(bounds, bytes_w.astype(jnp.int32),
                             side="right").astype(jnp.int32)
    slot_iota = jnp.arange(NS, dtype=jnp.int32)[None, :]       # [1, NS]

    def body(carry, xc):
        st, slots, ok = carry
        c, pos = xc
        oh_s = (st[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (1, S), 1)).astype(jnp.float32)          # [B, S]
        # HIGHEST precision: the slot-mask channels carry 16-bit values,
        # and a default-precision product (TF32 on the GPU) rounds
        # integers above 2048; exact f32 keeps the mask round-trip
        rows = jnp.dot(oh_s, comb,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)      # [B, 3C+4]
        oh_c = (c[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (1, C), 1))                              # [B, C]
        nxt = jnp.sum(jnp.where(oh_c, rows[:, :C], 0.0),
                      axis=1).astype(jnp.int32)
        lo = jnp.sum(jnp.where(oh_c, rows[:, C:2 * C], 0.0),
                     axis=1).astype(jnp.int32)
        hi = jnp.sum(jnp.where(oh_c, rows[:, 2 * C:3 * C], 0.0),
                     axis=1).astype(jnp.int32)
        mask = lo | (hi << 16)
        valid = pos < ends
        at_end = pos == ends
        # match application at pos == end: match_cond + match_slots
        mcond = rows[:, 3 * C] > 0.5
        mmask = (rows[:, 3 * C + 1].astype(jnp.int32)
                 | (rows[:, 3 * C + 2].astype(jnp.int32) << 16))
        ok = jnp.where(at_end, mcond, ok)
        end_bits = ((mmask[:, None] >> slot_iota) & 1) > 0
        slots = jnp.where((at_end & mcond)[:, None] & end_bits,
                          pos[:, None], slots)
        # transition application while inside the span
        bits = ((mask[:, None] >> slot_iota) & 1) > 0
        slots = jnp.where(valid[:, None] & bits, pos[:, None], slots)
        st = jnp.where(valid, nxt, st)
        return (st, slots, ok), None

    st0 = jnp.full((B,), start, jnp.int32)
    slots0 = jnp.full((B, NS), -1, jnp.int32)
    ok0 = jnp.zeros((B,), bool)
    (st, slots, ok), _ = jax.lax.scan(
        body, (st0, slots0, ok0), (cls_w.T, idx.T), unroll=4)
    return slots, ok


class OnePassScanner:
    """Batched capture extraction over verified match spans."""

    MAX_WINDOW = 1 << 14

    def __init__(self, op: OnePassDFA):
        self.d = DeviceOnePass(op)
        self.op = op

    def extract(self, data: jnp.ndarray, spans: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """spans [M, 2] int64 -> (slots [M, NS] int64, ok [M] bool).

        Spans wider than MAX_WINDOW report ok=False (host re-extracts);
        the rest run in width-bucketed batches so narrow spans don't pay
        wide-span windows.
        """
        d = self.d
        M = len(spans)
        NS = max(d.num_slots, 1)
        out = np.full((M, NS), -1, dtype=np.int64)
        ok = np.zeros(M, dtype=bool)
        if M == 0:
            return out, ok
        widths = spans[:, 1] - spans[:, 0]
        order = np.argsort(widths, kind="stable")
        pos = 0
        while pos < M:
            w_lo = widths[order[pos]]
            W = int(max(_bucket(int(w_lo), 16), 16))
            hi = int(np.searchsorted(widths[order], W, side="right"))
            hi = max(hi, pos + 1)
            if W > self.MAX_WINDOW:
                break  # remaining spans too wide: host handles them
            sel = order[pos:hi]
            B = _bucket(len(sel), 16)
            sb = np.zeros(B, dtype=np.int32)
            eb = np.full(B, -1, dtype=np.int32)
            sb[:len(sel)] = spans[sel, 0]
            eb[:len(sel)] = spans[sel, 1]
            slots, okb = _onepass_window(
                d.comb, d.bounds, data, jnp.asarray(sb), jnp.asarray(eb),
                B=B, W=W, S=d.S, C=d.C, NS=NS, start=d.start)
            slots = np.asarray(jax.device_get(slots))[:len(sel)]
            okb = np.asarray(jax.device_get(okb))[:len(sel)]
            out[sel] = slots
            ok[sel] = okb
            pos = hi
        return out, ok
