"""Device count-scan kernels vs the CountDFA host oracle.

Runs on the CPU backend: the plain XLA scan directly, and the Triton
transducer kernel in interpreter mode on small inputs.  Small lanes force
many lane boundaries so the warmup/repair stitching is exercised hard.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from coregex_tpu.dfa.countdfa import build_count_dfa
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops.count_scan import CountScanner
from coregex_tpu.ops.transducer import plan_geometry
from coregex_tpu.syntax.parser import parse

PATTERNS = [
    r"\d+\.\d+\.\d+\.\d+",
    r"(?m)^/.*\.php",
    r".*keyword.*",
    r"[\w]+",
    r"error",
    r"\bword\b",
    r"a+b",
]

ALPHABET = b"ab.0123456789 keyword/xyzphtw\nerror"


def _build(pattern):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    u = determinize(nfa, anchored=False, break_at_match=True)
    cd = build_count_dfa(u)
    assert cd is not None
    return cd


def _make_corpus(seed, n):
    rng = random.Random(seed)
    return bytes(rng.choice(ALPHABET) for _ in range(n))


def _small(n):
    """Geometry with 32-byte lanes: many lanes even for tiny inputs."""
    return plan_geometry(n, min_lane_bytes=32, warmup=16)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_gather_impl_matches_oracle(pattern):
    cd = _build(pattern)
    sc = CountScanner(cd, impl="xla")
    rng = random.Random(42)
    for n in [1, 3, 17, 255, 256, 1000, 4096, 9999]:
        data = _make_corpus(rng.random(), n)
        arr = np.frombuffer(data, dtype=np.uint8)
        dev = jnp.asarray(arr)
        got = sc.count(dev)
        exp = cd.count_scan(arr)
        assert got == exp, (pattern, n)


def test_many_lane_boundaries():
    """Tiny lanes -> hundreds of lanes; stitching must stay exact."""
    cd = _build(r"\d+\.\d+\.\d+\.\d+")
    sc = CountScanner(cd, impl="xla")
    data = (b"ip 10.1.2.3 and 192.168.0.255 plus 1.2.3.4.5.6 " * 200)
    arr = np.frombuffer(data, dtype=np.uint8)
    got = sc.count(jnp.asarray(arr), geometry=_small(len(arr)))
    assert got == cd.count_scan(arr)


def test_matches_crossing_boundaries():
    """Long matches that straddle chunk edges (repair rounds > 0)."""
    cd = _build(r"a+b")
    sc = CountScanner(cd, impl="xla")
    data = b"a" * 5000 + b"b" + b"a" * 3000 + b"b" + b"c" * 100
    arr = np.frombuffer(data, dtype=np.uint8)
    got = sc.count(jnp.asarray(arr), geometry=_small(len(arr)))
    # matches longer than a chunk defeat warmup; either exact or an
    # honest non-convergence (None)
    assert got is None or got == cd.count_scan(arr)


def test_eoi_commit():
    """Match ending exactly at n (pending flag committed at EOI)."""
    cd = _build(r"\d+\.\d+\.\d+\.\d+")
    sc = CountScanner(cd, impl="xla")
    data = b"x" * 500 + b"10.0.0.1"
    arr = np.frombuffer(data, dtype=np.uint8)
    got = sc.count(jnp.asarray(arr), geometry=_small(len(arr)))
    assert got == cd.count_scan(arr) == 1


@pytest.mark.parametrize("pattern", [r"[\w]+", r"a+b", r"\bword\b"])
def test_pallas_interpret_matches_oracle(pattern, triton_interpret):
    """The Triton kernel (interpret mode) gives the oracle's count."""
    cd = _build(pattern)
    sc = CountScanner(cd, impl="triton")
    data = _make_corpus(7, 2000)
    arr = np.frombuffer(data, dtype=np.uint8)
    got = sc.count(jnp.asarray(arr), geometry=_small(len(arr)))
    assert got == cd.count_scan(arr)


def test_count_from_chains_segments():
    """count_from with the exit state carried over segments is the
    sequential scan (the one-card reference of the sharded count)."""
    import jax
    from coregex_tpu.dfa.dense import CTX_SOT
    cd = _build(r"\d+\.\d+")
    sc = CountScanner(cd, impl="xla")
    data = np.frombuffer(_make_corpus(3, 3000), dtype=np.uint8)
    s, total = int(cd.starts[CTX_SOT]), 0
    for lo in range(0, 3000, 700):
        cnt, s, conv = jax.device_get(
            sc.count_from(jnp.asarray(data[lo:lo + 700]), s))
        assert bool(conv)
        total, s = total + int(cnt), int(s)
    total += int(cd.eoi_commits[s, CTX_SOT])
    assert total == cd.count_scan(data)
