"""Mesh-sharded scan correctness on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.parallel.shard import (default_mesh, make_sharded_count,
                                        make_sharded_flags)
from coregex_tpu.syntax.parser import parse


def build_fwd_all(pattern):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    return determinize(nfa, anchored=False, break_at_match=False)


@pytest.mark.parametrize("pattern", [r"abc", r"\d+\.\d+", r"\bfoo\b",
                                     r"(?m)^x.*"])
def test_sharded_count_matches_host(pattern):
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(1)
    text = rng.choice(list(b"abc foo 12.5\nx9 "), size=16_384).astype(np.uint8)
    dense = build_fwd_all(pattern)
    ddfa = DeviceDFA.from_dense(dense)
    mesh = default_mesh()
    fn = make_sharded_count(mesh, ddfa)
    got = int(fn(np.asarray(text)))
    exp = int(build_fwd_all(pattern).scan_all_ends(text).sum())
    assert got == exp, f"{pattern}: sharded {got} vs host {exp}"


def test_sharded_flags_exact():
    rng = np.random.default_rng(2)
    text = rng.choice(list(b"ab 12.5 cd\n"), size=8_192).astype(np.uint8)
    dense = build_fwd_all(r"\d+\.\d+")
    ddfa = DeviceDFA.from_dense(dense)
    fn = make_sharded_flags(default_mesh(), ddfa)
    got = np.asarray(jax.device_get(fn(np.asarray(text))))
    exp = dense.scan_all_ends(text)[:-1]
    assert np.array_equal(got, exp)


class TestShardedEngineCount:
    """Engine.count through the mesh (round 2: the public API reaches the
    multi-chip path, VERDICT item 6)."""

    def test_engine_count_sharded_matches_host(self):
        import jax
        from coregex_tpu.meta.engine import Engine
        assert len(jax.devices()) >= 8
        text = (b"a1.2.3b 10.0.0.1 v9.9.9 xx 1.2 " * 257)[:-5]
        eng = Engine.compile(r"\d+\.\d+\.\d+")
        eng.batch_threshold = 0
        got = eng.count(text)
        assert eng.batch_engine().served_by == "count_transducer_sharded", \
            "multi-device mesh must activate the sharded counter"
        host = Engine.compile(r"\d+\.\d+\.\d+")
        host.batch_threshold = 1 << 60
        assert got == host.count(text)

    def test_engine_find_all_sharded_spans(self):
        """find_all runs on one device even with a mesh visible (start
        discovery is no longer sharded) and agrees with the host loop
        span-for-span; count on the same engine shards."""
        import re

        import numpy as np
        from coregex_tpu.meta.engine import Engine
        from coregex_tpu.utils.corpus_cache import device_corpus
        rng = np.random.default_rng(4)
        corpus = (b" ".join(
            [b"aa@bb", b"3.14", b"xy", b"zz@q", b"9.9.9",
             bytes(rng.choice(list(b"abc @.123"), size=20))]) + b"\n") * 800
        arr = np.frombuffer(corpus, np.uint8)
        for pat in [r"[a-z]+@[a-z]+", r"\d+\.\d+"]:
            e = Engine.compile(pat)
            e.batch_threshold = 0
            be = e.batch_engine()
            spans = be._full_scan_spans(device_corpus(arr), arr,
                                        len(arr), -1)
            got = [(int(s), int(q)) for s, q in spans]
            exp = [m.span() for m in re.finditer(pat.encode(), corpus)]
            assert len(exp) > 0 and got == exp, pat
            assert e.count(corpus) == len(exp)
            assert be.served_by == "count_transducer_sharded"

    def test_sharded_go_count_tail_and_empty(self):
        import numpy as np
        from coregex_tpu.dfa.countdfa import build_count_dfa
        from coregex_tpu.dfa.determinize import determinize
        from coregex_tpu.meta.engine import Engine
        from coregex_tpu.nfa.thompson import compile_nfa
        from coregex_tpu.ops.count_scan import CountScanner
        from coregex_tpu.parallel.shard import default_mesh
        from coregex_tpu.parallel.sharded_count import ShardedGoCount
        e = Engine.compile(r"ab+")
        nfa = compile_nfa(e.parsed, with_captures=False)
        cd = build_count_dfa(
            determinize(nfa, anchored=False, break_at_match=True))
        shc = ShardedGoCount(CountScanner(cd), default_mesh())
        host = Engine.compile(r"ab+")
        host.batch_threshold = 1 << 60
        for text in (b"", b"ab", b"abbb xx ab a abb" * 37 + b"ab",
                     b"x" * 8 + b"abb"):
            arr = np.frombuffer(text, np.uint8)
            assert shc.count(arr) == host.count(text), text[:20]


def _sharded(pattern):
    from coregex_tpu.dfa.countdfa import build_count_dfa
    from coregex_tpu.ops.count_scan import CountScanner
    from coregex_tpu.parallel.sharded_count import ShardedGoCount
    nfa = compile_nfa(parse(pattern), with_captures=False)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    return ShardedGoCount(CountScanner(cd), default_mesh()), cd


@pytest.mark.parametrize("n", [7, 8 * 64 + 3, 8 * 4096, 8 * 4096 + 17])
def test_phase1_state_gate(n):
    """Shard stitching at any length, incl. shards past the corpus end
    (empty shards must not break the chain)."""
    shc, cd = _sharded(r"\d+\.\d+")
    rng = np.random.default_rng(n)
    data = rng.choice(list(b"ab 12.5 cd\n9"), size=n).astype(np.uint8)
    assert shc.count(data) == cd.count_scan(data)


@pytest.mark.parametrize("pattern", [r"a+b", r"(?m)^x[^\n]*y", r"\bab\b"])
def test_phase_probe_counts_match(pattern):
    """Shard-level repair: matches longer than the halo straddle the
    shard boundaries, so halo guesses can be wrong and shards rescan
    from the previous shard's exit; the count stays exact."""
    shc, cd = _sharded(pattern)
    unit = b"x" + b"a" * 150 + b"b y\nab "
    data = np.frombuffer(unit * 240, np.uint8)
    assert cd.count_scan(data) > 0
    assert shc.count(data) == cd.count_scan(data)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_count_submesh(ndev):
    """The counter on 2, 4 and 8 devices of the mesh."""
    from coregex_tpu.dfa.countdfa import build_count_dfa
    from coregex_tpu.ops.count_scan import CountScanner
    from coregex_tpu.parallel.sharded_count import ShardedGoCount
    nfa = compile_nfa(parse(r"[a-z]+@[a-z]+"), with_captures=False)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    shc = ShardedGoCount(CountScanner(cd), default_mesh(ndev))
    data = np.frombuffer(b"aa@bb x@ y@zz qq@ww@ee " * 333, np.uint8)
    assert shc.count(data) == cd.count_scan(data)
