"""Property tests for the payload compaction kernel + sparse chain
(ops/compact2.py) against numpy flatnonzero."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from coregex_tpu.ops.compact2 import (compact_pay, sparse_positions,
                                      positions_auto)


def _ref(mask):
    return np.flatnonzero(mask)


@pytest.mark.parametrize("dens", [0.0, 0.001, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("npay", [0, 1, 2])
def test_compact_pay_interpret(dens, npay):
    rng = np.random.default_rng(int(dens * 1000) + npay)
    R = 256
    n = 2 * R * 128 + 77  # force padding
    mask = (rng.random(n) < dens)
    pays = [rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
            for _ in range(npay)]
    exp = _ref(mask)
    cap = max(16, len(exp) + 5)
    out = compact_pay(jnp.asarray(mask),
                      [jnp.asarray(p) for p in pays], cap)
    pos, rest = out[0], out[1:]
    pvs, cnt, ok = rest[:npay], rest[npay], rest[npay + 1]
    pos, cnt, ok = (np.asarray(jax.device_get(x))
                    for x in (pos, cnt, ok))
    assert bool(ok)
    assert int(cnt) == len(exp)
    assert (pos[:len(exp)] == exp).all()
    assert (pos[len(exp):] >= n).all()
    for k in range(npay):
        pv = np.asarray(jax.device_get(pvs[k]))
        assert (pv[:len(exp)] == pays[k][exp]).all()


def test_compact_pay_xla_fallback():
    rng = np.random.default_rng(3)
    n = 5000  # < 4*CH -> XLA scatter path
    mask = (rng.random(n) < 0.1)
    pay = rng.integers(0, 100, n, dtype=np.int32)
    exp = _ref(mask)
    pos, pv, cnt, ok = compact_pay(jnp.asarray(mask),
                                   [jnp.asarray(pay)], len(exp) + 16)
    assert bool(ok) and int(cnt) == len(exp)
    assert (np.asarray(pos)[:len(exp)] == exp).all()
    assert (np.asarray(pv)[:len(exp)] == pay[exp]).all()


def test_compact_pay_overflow_flag():
    rng = np.random.default_rng(4)
    n = 5 * 256 * 128
    mask = (rng.random(n) < 0.2)
    exp = _ref(mask)
    cap = 128  # far under the true count
    out = compact_pay(jnp.asarray(mask), (), cap)
    pos, cnt, ok = out
    assert not bool(jax.device_get(ok))


@pytest.mark.parametrize("dens", [0.0, 0.0005, 0.01, 0.2])
def test_sparse_positions(dens):
    rng = np.random.default_rng(int(dens * 10000) + 9)
    n = 3 * 256 * 128 * 4 + 1000
    mask = (rng.random(n) < dens)
    # clustered hits exercise multi-bit words
    for c in rng.integers(0, n - 40, 20):
        mask[c:c + 8] = True
    exp = _ref(mask)
    cap = max(16, len(exp) + 3)
    pos, cnt, ok = sparse_positions(jnp.asarray(mask), cap)
    pos, cnt, ok = (np.asarray(jax.device_get(x))
                    for x in (pos, cnt, ok))
    assert bool(ok)
    assert int(cnt) == len(exp)
    assert (pos[:len(exp)] == exp).all()
    assert (pos[len(exp):] == n).all()


def test_sparse_positions_cap_exceeded():
    rng = np.random.default_rng(12)
    n = 256 * 128 * 4 * 4
    mask = (rng.random(n) < 0.05)
    exp = _ref(mask)
    pos, cnt, ok = sparse_positions(jnp.asarray(mask), len(exp) // 2)
    assert not bool(jax.device_get(ok))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_sparse_events_words(K):
    from coregex_tpu.ops.compact2 import (pack_words, sparse_events_words)
    rng = np.random.default_rng(40 + K)
    n = 256 * 128 * 4 * 2 + 555
    nw = -(-n // 32)
    masks = [(rng.random(n) < d) for d in (0.002, 0.01, 0.0005, 0.03)[:K]]
    mp = [np.pad(m, (0, nw * 32 - n)) for m in masks]
    words = [np.asarray(jax.device_get(
        pack_words(jnp.asarray(m.astype(np.int8)), nw))) for m in mp]
    union = np.logical_or.reduce(masks)
    exp_pos = np.flatnonzero(union)
    exp_kind = np.zeros(len(exp_pos), dtype=np.int32)
    for kk, m in enumerate(masks):
        exp_kind |= (m[exp_pos].astype(np.int32) << kk)
    cap = max(16, len(exp_pos) + 7)
    pos, kind, cnt, ok = sparse_events_words(
        [jnp.asarray(w) for w in words], n, cap)
    pos, kind, cnt, ok = (np.asarray(jax.device_get(x))
                          for x in (pos, kind, cnt, ok))
    assert bool(ok)
    assert int(cnt) == len(exp_pos)
    assert (pos[:len(exp_pos)] == exp_pos).all()
    assert (kind[:len(exp_pos)] == exp_kind).all()
    assert (pos[len(exp_pos):] == n).all()


@pytest.mark.parametrize("P", [1, 2, 3])
def test_sparse_chain_payloads(P):
    from coregex_tpu.ops.compact2 import (pack_words,
                                          sparse_chain_payloads)
    rng = np.random.default_rng(60 + P)
    n = 256 * 128 * 4 * 2 + 100
    nw = -(-n // 32)
    mask = rng.random(n) < 0.004
    mp = np.pad(mask, (0, nw * 32 - n))
    words = np.asarray(jax.device_get(
        pack_words(jnp.asarray(mp.astype(np.int8)), nw)))
    pays = [rng.integers(-2**31, 2**31 - 1, nw, dtype=np.int32)
            for _ in range(P)]
    exp = np.flatnonzero(mask)
    cap = max(16, len(exp) + 9)
    out = sparse_chain_payloads(jnp.asarray(words),
                                [jnp.asarray(p) for p in pays], n, cap)
    pos = np.asarray(jax.device_get(out[0]))
    cnt = int(jax.device_get(out[1 + P]))
    ok = bool(jax.device_get(out[2 + P]))
    assert ok and cnt == len(exp)
    assert (pos[:cnt] == exp).all()
    for k in range(P):
        pv = np.asarray(jax.device_get(out[1 + k]))
        assert (pv[:cnt] == pays[k][exp // 32]).all()


def test_multi_literal_words_big_matches_fused(monkeypatch):
    from coregex_tpu.ops import span_chain
    from coregex_tpu.ops.span_chain import (multi_literal_words,
                                            multi_literal_words_big)
    # force several segments so slice halos/boundaries are exercised
    monkeypatch.setattr(span_chain, "_ML_SEG", 4096)
    rng = np.random.default_rng(77)
    words = [b"error", b"warning", b"warn", b"ab", b"errors", b"ninety9",
             b"xy"]
    parts = []
    for _ in range(4000):
        parts.append(bytes(rng.integers(97, 110, rng.integers(1, 9),
                                        dtype=np.uint8)))
        if rng.random() < 0.3:
            parts.append(words[int(rng.integers(len(words)))])
    data = b" ".join(parts)
    dev = jnp.asarray(np.frombuffer(data, dtype=np.uint8))
    lits = tuple(tuple(w) for w in words)
    a = multi_literal_words(dev, lits)
    b = multi_literal_words_big(dev, lits)
    for x, y in zip(a, b):
        xa, ya = np.asarray(jax.device_get(x)), np.asarray(
            jax.device_get(y))
        m = min(len(xa.reshape(-1)), len(ya.reshape(-1))) \
            if xa.ndim else None
        assert (xa == ya).all() if xa.shape == ya.shape else \
            (xa.reshape(-1)[:m] == ya.reshape(-1)[:m]).all()


def test_positions_auto_routes():
    rng = np.random.default_rng(21)
    n = 256 * 128 * 4 * 2
    mask = (rng.random(n) < 0.002)
    exp = _ref(mask)
    for hint in (len(exp), None, n // 2):
        pos, cnt, ok = positions_auto(jnp.asarray(mask),
                                      max(16, len(exp) + 8),
                                      nhits_hint=hint)
        assert bool(jax.device_get(ok))
        assert int(jax.device_get(cnt)) == len(exp)
        assert (np.asarray(jax.device_get(pos))[:len(exp)] == exp).all()
