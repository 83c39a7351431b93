"""The transducer kernel (ops/transducer.py) and what surrounds it.

The Triton kernel runs here in Pallas interpret mode and must agree
exactly with the plain XLA scan and with the host oracles, in all three
modes (count, events, flags), on lane geometries small enough that
matches straddle lanes and repair rounds run.  Also: the lane geometry,
the integer word packing, the cache-dir helper, device errors reaching
the caller, and chip_smoke's refusal to run off the GPU.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coregex_tpu.dfa.countdfa import build_count_dfa
from coregex_tpu.dfa.dense import CTX_OTHER
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.meta.engine import Engine
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import transducer as tx
from coregex_tpu.ops.count_scan import CountScanner
from coregex_tpu.syntax.parser import parse

import bench

BENCH = [(name, pat) for name, pat, _r, _s in bench.CONFIGS]
EXTRA = [
    ("utf8_letters", r"\p{L}+"),
    ("word_boundary", r"\bfox\b"),
    ("line_start", r"(?m)^[a-z]+"),
    ("fold", r"(?i)ERROR|warn"),
]

_BASE = None


def _corpus(n: int, utf8: bool = False) -> bytes:
    """Bench-style log lines, optionally with multi-byte UTF-8 words."""
    global _BASE
    if _BASE is None:
        _BASE = bench.build_base(size=40_000, seed=3)
    text = _BASE
    if utf8:
        text = text.replace(b"lorem", "lörem".encode()).replace(
            b"dolor", "долор".encode())
    return (text * (n // len(text) + 1))[:n]


def _count_dfa(pattern: str, nullable: bool = False):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    if nullable:
        from coregex_tpu.dfa.countdfa import build_count_dfa_nullable
        from coregex_tpu.dfa.determinize import determinize_py
        u = determinize_py(nfa, anchored=False, break_at_match=True,
                           track_empty=True)
        return build_count_dfa_nullable(u)
    return build_count_dfa(determinize(nfa, anchored=False,
                                       break_at_match=True))


def _geometry(n):
    # 64-byte lanes, 16-byte warmup: dozens of lanes, matches straddle
    return tx.plan_geometry(n, min_lane_bytes=64, warmup=16)


# ---------------------------------------------------------------------------
# count mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,pattern", BENCH + EXTRA)
def test_count_kernel_matches_oracle(name, pattern, triton_interpret):
    cd = _count_dfa(pattern)
    assert cd is not None
    utf8 = name == "utf8_letters"
    data = np.frombuffer(_corpus(6000, utf8=utf8), dtype=np.uint8)
    dev = jnp.asarray(data)
    geo = _geometry(len(data))
    exp = cd.count_scan(data)
    assert CountScanner(cd, impl="xla").count(dev, geo) == exp
    assert CountScanner(cd, impl="triton").count(dev, geo) == exp


@pytest.mark.parametrize("pattern", [r"a*", r"\b", r"(?m)^"])
def test_count_kernel_nullable(pattern, triton_interpret):
    cd = _count_dfa(pattern, nullable=True)
    data = np.frombuffer(b"ab aab\nb a\n\nxa" * 40, dtype=np.uint8)
    dev = jnp.asarray(data)
    geo = _geometry(len(data))
    exp = cd.count_scan(data)
    assert CountScanner(cd, impl="xla").count(dev, geo) == exp
    assert CountScanner(cd, impl="triton").count(dev, geo) == exp


@pytest.mark.parametrize("mode", ["count", "events", "flags"])
@pytest.mark.parametrize("pattern", [r"\d+\.\d+\.\d+\.\d+",
                                     r"[\w.+-]+@[\w.-]+\.[\w.-]+",
                                     r"\d+.\d+.\d+"])
def test_scan_lanes_triton_equals_xla(mode, pattern, triton_interpret):
    """One pass of every lane, raw outputs, incl. partial last lane and
    an `active` mask that keeps inactive lanes' previous outputs."""
    cd = _count_dfa(pattern)
    data = jnp.asarray(np.frombuffer(_corpus(5000), dtype=np.uint8))
    L, T, W = _geometry(5000)
    words = tx.make_word_tiles(data, L, T // 4)
    if mode == "flags":
        S, C = cd.delta.shape
        syms = (np.arange(256) % (2 * C)).astype(np.int32)
        table = jnp.asarray((cd.delta[:, np.arange(2 * C) // 2] * 32
                             + (np.arange(2 * C) % 2)).reshape(-1)
                            .astype(np.int32))
        words = tx.make_word_tiles(
            jnp.asarray(syms)[data.astype(jnp.int32)].astype(jnp.uint8),
            L, T // 4)
        cmap, nc = None, 2 * C
    else:
        S, C = cd.delta.shape
        emit = cd.emit if mode == "count" else (
            cd.flag_on.astype(np.int32) | (cd.first_on << 1)
            | (cd.emit.astype(np.int32) << 2))
        table = jnp.asarray((cd.delta * 32 + emit).reshape(-1)
                            .astype(np.int32))
        cmap, nc = jnp.asarray(cd.classes.astype(np.int32)), C
    rng = np.random.default_rng(5)
    entries = jnp.asarray(rng.integers(0, S, L).astype(np.int32))
    offsets = tx.first_lane_offsets(L, W)
    limits = tx.lane_limits(4999, L, T)
    warm = tx.warm_window(words, W)
    args = (table, cmap, entries, offsets, limits, warm, words, nc)
    a = tx.scan_lanes("triton", mode, *args)
    b = tx.scan_lanes("xla", mode, *args)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    active = jnp.asarray(rng.random(L) < 0.3)
    prev = tuple(o + 7 for o in b)
    a2 = tx.scan_lanes("triton", mode, *args, active=active, prev=prev)
    b2 = tx.scan_lanes("xla", mode, *args, active=active, prev=prev)
    for x, y in zip(a2, b2):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# events and flags modes through their scanners
# ---------------------------------------------------------------------------

SPAN_PATTERNS = [r"\d+\.\d+\.\d+\.\d+", r"\d+.\d+.\d+",
                 r"[\w.+-]+@[\w.-]+\.[\w.-]+", r"\w+://[^\s]+"]


@pytest.mark.parametrize("pattern", SPAN_PATTERNS)
def test_events_kernel_equals_xla(pattern, triton_interpret):
    from coregex_tpu.ops.span_scan import SpanScanner
    cd = _count_dfa(pattern).minimized()
    assert cd.spans_simple
    data = jnp.asarray(np.frombuffer(_corpus(7000), dtype=np.uint8))
    geo = _geometry(7000)
    a = SpanScanner(cd, impl="triton").scan(data, geo)
    b = SpanScanner(cd, impl="xla").scan(data, geo)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    # flag words mark exactly the candidate ends the host walk produces
    assert int(a[3]) == len(re.findall(pattern.encode(),
                                       _corpus(7000)))


@pytest.mark.parametrize("pattern", SPAN_PATTERNS)
def test_flags_kernel_equals_xla(pattern, triton_interpret):
    from coregex_tpu.ops.dfa_scan import DeviceDFA
    from coregex_tpu.ops.flag_scan import FlagResetScanner
    be = Engine.compile(pattern).batch_engine()
    be._dense("rev_anch_ascii")
    dd = DeviceDFA.from_dense(be._host_dense["rev_anch_ascii"].minimized())
    text = _corpus(6000)
    data = jnp.asarray(np.frombuffer(text, dtype=np.uint8))
    rmask = data == ord(" ")
    outs = {}
    for impl in ("triton", "xla"):
        sc = FlagResetScanner(dd, CTX_OTHER, impl=impl, flag_pre_reset=True)
        outs[impl] = sc.scan_words(data, rmask)
    for x, y in zip(outs["triton"], outs["xla"]):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert bool(outs["xla"][2])


@pytest.mark.parametrize("name,pattern", BENCH)
def test_engine_count_and_spans_on_kernel(name, pattern, triton_interpret):
    """The public API with the transducer on the Triton kernel."""
    text = _corpus(20_000)
    eng = Engine.compile(pattern)
    eng.batch_threshold = 0
    exp = [m.span() for m in re.finditer(pattern.encode(), text)]
    assert eng.count(text) == len(exp)
    assert (eng.find_all_index(text) or []) == exp


# ---------------------------------------------------------------------------
# geometry, word packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 4095, 4096, 100_000,
                               6 << 20, 1536 << 20, 1610608640])
def test_plan_geometry(n):
    L, T, W = tx.plan_geometry(n)
    assert L & (L - 1) == 0 and tx.MIN_LANES <= L <= tx.MAX_LANES
    assert T % 32 == 0 and L * T >= n
    assert W % 4 == 0 and 4 <= W <= T
    if n >= tx.MAX_LANES * tx.MIN_LANE_BYTES:
        assert L == tx.MAX_LANES
    # one compiled geometry per size bucket
    assert tx.plan_geometry(tx.size_bucket(n)) == (L, T, W)


@pytest.mark.parametrize("n,L,T4", [(1, 8, 8), (999, 128, 8),
                                    (4096, 128, 8), (70_000, 256, 72)])
def test_word_tiles_match_numpy(n, L, T4):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n).astype(np.uint8)
    got = np.asarray(tx.make_word_tiles(jnp.asarray(data), L, T4))
    ref = np.pad(data, (0, L * T4 * 4 - n)).view("<i4").reshape(L, T4).T
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("dens", [0.0, 0.02, 0.5, 1.0])
def test_pack_words_matches_numpy(dens):
    from coregex_tpu.ops.compact2 import pack_words
    rng = np.random.default_rng(int(dens * 100))
    mask = rng.random(32 * 300) < dens
    got = np.asarray(pack_words(jnp.asarray(mask), 300))
    ref = np.packbits(mask.reshape(300, 32), axis=1,
                      bitorder="little").view("<i4").reshape(-1)
    assert np.array_equal(got, ref)


def test_positions_major_masks_past_n():
    w = jnp.full((2, 3), -1, jnp.int32)   # 2 words per lane, 3 lanes
    got = np.asarray(tx.positions_major(w, 70))
    assert got.tolist() == [-1, -1, (1 << 6) - 1, 0, 0, 0]


# ---------------------------------------------------------------------------
# compile cache, errors, chip_smoke's platform check
# ---------------------------------------------------------------------------

def test_compile_cache_default_dir(monkeypatch, tmp_path):
    from coregex_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache(str(tmp_path))
        assert got == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == os.path.join(
            compile_cache.CHECKOUT, ".jax_cache")
        assert os.path.isdir(os.path.join(compile_cache.CHECKOUT,
                                          "coregex_tpu"))
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    from coregex_tpu.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    old = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == old  # nothing set


def test_device_scanner_error_reaches_caller(monkeypatch):
    """A failing device scanner is not retired into a slower path."""
    from coregex_tpu.meta.batch import BatchEngine
    eng = Engine.compile(r"\d+\.\d+\.\d+\.\d+")
    eng.batch_threshold = 0

    def boom(self, *a, **kw):
        raise RuntimeError("device kernel failed")

    monkeypatch.setattr(BatchEngine, "_sharded_counter",
                        lambda self, sc: False)   # the one-card path
    monkeypatch.setattr(CountScanner, "count", boom)
    with pytest.raises(RuntimeError, match="device kernel failed"):
        eng.count(b"10.0.0.1 x" * 50)


def test_sharded_error_reaches_caller(monkeypatch):
    from coregex_tpu.parallel.sharded_count import ShardedGoCount
    eng = Engine.compile(r"ab+")
    eng.batch_threshold = 0

    def boom(self, data):
        raise RuntimeError("collective failed")

    monkeypatch.setattr(ShardedGoCount, "count", boom)
    assert len(jax.devices()) > 1
    with pytest.raises(RuntimeError, match="collective failed"):
        eng.count(b"abb " * 100)


def test_chip_smoke_refuses_cpu():
    import chip_smoke
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_chip_smoke_main_refuses_cpu(capsys):
    import chip_smoke
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
