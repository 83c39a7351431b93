"""Stream compaction (ops/compact.py): positions of set entries via a
cumsum rank and one unique-index scatter, against numpy flatnonzero."""

import numpy as np
import pytest

import jax.numpy as jnp

from coregex_tpu.ops.compact import _compact_xla_jit, compact_positions

CH = 1 << 14  # a block-sized stride for the test shapes


def _check(h, cap, out, cnt):
    exp = np.flatnonzero(h)
    n = len(h)
    assert int(cnt) == len(exp)
    out = np.asarray(out)
    take = min(cap, len(exp))
    assert np.array_equal(out[:take], exp[:take])
    if len(exp) < cap:
        assert (out[len(exp):] >= n).all()


@pytest.mark.parametrize("blocks,dens", [
    (4, 0.0), (4, 0.003), (4, 0.25), (4, 0.97), (4, 1.0), (7, 0.5),
])
def test_kernel_interpret_vs_flatnonzero(blocks, dens):
    rng = np.random.default_rng(blocks * 100 + int(dens * 100))
    n = blocks * CH
    h = (rng.random(n) < dens).astype(np.int8)
    cap = 1 << max(4, int(h.sum()).bit_length())
    out, cnt = _compact_xla_jit(jnp.asarray(h), cap)
    _check(h, cap, out, cnt)


def test_kernel_interpret_adversarial_blocks():
    """Runs of every shape and a cap smaller than the hit count."""
    n = 5 * CH
    h = np.zeros(n, dtype=np.int8)
    h[CH - 1] = 1
    h[CH:CH + 127] = 1
    h[2 * CH + 5:2 * CH + 7000] = 1
    h[5 * CH - 3:] = 1
    cap = 1 << int(h.sum()).bit_length()
    out, cnt = _compact_xla_jit(jnp.asarray(h), cap)
    _check(h, cap, out, cnt)
    out, cnt = _compact_xla_jit(jnp.asarray(h), 64)  # truncated
    _check(h, 64, out, cnt)


@pytest.mark.parametrize("dtype", [np.int8, np.bool_, np.int32])
@pytest.mark.parametrize("dens", [0.0, 0.01, 0.5, 1.0])
def test_compact_positions_densities(dtype, dens):
    rng = np.random.default_rng(int(dens * 1000) + 7)
    h = (rng.random(3 * CH + 5) < dens).astype(dtype)
    cap = 1 << max(4, int((h != 0).sum()).bit_length())
    out, cnt = compact_positions(jnp.asarray(h), cap)
    _check(h != 0, cap, out, cnt)


def test_xla_fallback_and_dispatch():
    rng = np.random.default_rng(11)
    for n in (0, 5, 1000, 3 * CH + 17):
        h = (rng.random(n) < 0.3).astype(np.int8)
        cap = 1 << max(4, int(h.sum()).bit_length())
        out, cnt = compact_positions(jnp.asarray(h), cap)
        _check(h, cap, out, cnt)


def test_mask_nonzero_contract_unchanged():
    """bytescan._mask_nonzero keeps its sentinel-n contract through the
    new dispatch."""
    from coregex_tpu.ops import bytescan as bs
    rng = np.random.default_rng(13)
    h = rng.random(100_000) < 0.01
    cap = 2048
    out = np.asarray(bs._mask_nonzero(jnp.asarray(h), cap))
    exp = np.flatnonzero(h)
    assert np.array_equal(out[:len(exp)], exp)
    assert (out[len(exp):] == 100_000).all()
