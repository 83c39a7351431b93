"""Offset byte-range sieve — DFA-derived candidate prefilter.

Generalizes the reference's Teddy fingerprints and DigitPrefilter
(prefilter/teddy.go nibble masks, prefilter/digit.go): from the anchored
DFA, compute for each offset j < depth the set of bytes that can possibly
appear j bytes into a match.  A candidate start must satisfy ALL offset
conditions — evaluated on device as pure shifted range-compares (no gathers),
so sieving a corpus costs a few elementwise passes regardless of pattern.

depth is capped at the pattern's minimum match length so positions are
never wrongly excluded (every true match has >= depth bytes).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..dfa.dense import CTX_SOT, DEAD, DenseDFA

Ranges = Tuple[Tuple[int, int], ...]


def offset_byte_ranges(dfa: DenseDFA, depth: int = 8,
                       max_ranges: int = 8) -> List[Ranges]:
    """Per-offset allowed byte ranges from the anchored DFA (host).

    Stops early when a level admits all bytes (no selectivity), exceeds
    max_ranges, or a match could already have ended (shorter matches must
    not be sieved away)."""
    S, C = dfa.delta.shape
    cur = set(int(s) for s in dfa.starts if s != DEAD)
    out: List[Ranges] = []
    for _ in range(depth):
        if not cur:
            break
        # a match could end at this offset -> stop (no constraint beyond)
        if any(dfa.match_on[s].any() or dfa.match_eoi[s].any()
               for s in cur):
            break
        allowed_cls = set()
        nxt = set()
        for s in cur:
            for c in range(C):
                t = int(dfa.delta[s, c])
                if t != DEAD:
                    allowed_cls.add(c)
                    nxt.add(t)
        allowed_bytes = np.isin(dfa.classes, list(allowed_cls))
        if allowed_bytes.all():
            break
        ranges: List[Tuple[int, int]] = []
        b = 0
        while b < 256:
            if allowed_bytes[b]:
                e = b
                while e + 1 < 256 and allowed_bytes[e + 1]:
                    e += 1
                ranges.append((b, e))
                b = e + 2
            else:
                b += 1
        if len(ranges) > max_ranges:
            break
        out.append(tuple(ranges))
        cur = nxt
    return out


def sieve_mask(data, per_offset: Sequence[Ranges]):
    """[n] bool device mask of positions passing all offset conditions.
    Positions within depth of the end are excluded (a match needs >= depth
    bytes by construction)."""
    import jax.numpy as jnp
    from .bytescan import _range_mask
    n = data.shape[0]
    depth = len(per_offset)
    if depth == 0:
        return jnp.ones((n,), dtype=bool)
    acc = None
    for j, ranges in enumerate(per_offset):
        m = _range_mask(data, tuple(ranges))
        if j:
            m = jnp.roll(m, -j)
        acc = m if acc is None else (acc & m)
    idxs = jnp.arange(n, dtype=jnp.int32)
    return acc & (idxs <= n - depth)
