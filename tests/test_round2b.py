"""Round-2 additions: END_ANCHORED strategy, FirstByteSet + PikeVM
skip-ahead, batched many-strings row scan (BranchDispatch analogue)."""

import re

import numpy as np
import pytest

from coregex_tpu.meta import literal as litmod
from coregex_tpu.meta.engine import Engine
from coregex_tpu.syntax.parser import parse


class TestEndAnchored:
    CASES = [
        (r"world$", "hello world"),
        (r"world$", "world hello"),
        (r"\w+\.(txt|log)$", "open notes.log"),
        (r"\w+\.(txt|log)$", "notes.log closed"),
        (r"x+$", "yyyxx"),
        (r"x+$", "yyy"),
        (r"(a|b)c$", "zac"),
        (r".*\.php$", "a/b/x.php"),
        (r"(foo|ba*r)$", "xbaaar"),
        (r"\d+$", "v1.2.33"),
    ]

    @pytest.mark.parametrize("pat,text", CASES)
    def test_vs_re(self, pat, text):
        e = Engine.compile(pat)
        assert e.strategy == "end_anchored"
        e.batch_threshold = 0
        m = re.search(pat, text)
        assert e.find_index(text) == (m.span() if m else None)
        assert e.is_match(text) == (m is not None)
        assert e.count(text) == (1 if m else 0)

    def test_not_end_anchored(self):
        # one alternative unanchored -> not the end-anchored strategy
        assert Engine.compile(r"a$|bb").strategy != "end_anchored"
        # nullable end-anchored stays on the host loop
        assert Engine.compile(r"a*$").strategy == "host"


class TestFirstBytes:
    def test_sets(self):
        assert litmod.first_bytes(parse(r"(foo|bar)").ast) == set(b"fb")
        assert litmod.first_bytes(parse(r"a*b").ast) == set(b"ab")
        assert litmod.first_bytes(parse(r"\d+\.\d+").ast) == \
            set(b"0123456789")
        assert litmod.first_bytes(parse(r"x?").ast) is None  # nullable
        assert litmod.first_bytes(parse(r".*x").ast) is None  # all bytes

    def test_utf8_lead_bytes(self):
        fb = litmod.first_bytes(parse("(é|ß)x").ast)
        assert fb is not None and 0xC3 in fb

    def test_pikevm_skip_correctness(self):
        # force the PikeVM path and exercise skip-ahead over a large gap
        e = Engine.compile(r"zq[0-9]+")
        e.batch_threshold = 1 << 60
        text = "a" * 100_000 + "zq42" + "b" * 10
        assert e.pikevm._fb_table is not None
        m = e.pikevm.search(text.encode(), 0)
        assert (m[0], m[1]) == (100_000, 100_004)


class TestRowBatch:
    TEXTS = [b"hello world", b"12.5 apples", b"", b"x" * 50,
             b"foo 1.2 bar 3.4", b"no digits here", b"7.7", b"end 9.",
             b"a" * 3, bytes(range(1, 120))]

    @pytest.mark.parametrize("pat", [
        r"\d+\.\d+", r"[a-z]+", r"^\d+", r"world$", r"\bfoo\b",
        r"a*b", r"(GET|POST) /", r"x+", r"^(\d+|[0-9a-f]{4})$",
    ])
    def test_vs_re(self, pat):
        e = Engine.compile(pat)
        got_m = e.is_match_batch(self.TEXTS)
        got_f = e.find_index_batch(self.TEXTS)
        for t, gm, gf in zip(self.TEXTS, got_m, got_f):
            m = re.search(pat.encode(), t)
            assert gm == (m is not None), (pat, t)
            assert gf == (m.span() if m else None), (pat, t)

    def test_large_batch(self):
        rng = np.random.default_rng(3)
        texts = []
        for _ in range(999):
            k = int(rng.integers(0, 40))
            texts.append(bytes(rng.choice(list(b"ab1.2 xy"), size=k)))
        e = Engine.compile(r"\d\.\d")
        got = e.is_match_batch(texts)
        for t, g in zip(texts, got):
            assert g == (re.search(rb"\d\.\d", t) is not None), t

    def test_host_fallback_longest(self):
        e = Engine.compile(r"a|ab", longest=True)
        assert e.is_match_batch([b"xaby"]) == [True]
        assert e.find_index_batch([b"xaby"]) == [(1, 3)]


class TestPaddingExactness:
    def test_nul_tail_no_phantom_match(self):
        """Zero padding in the chunked scan must not fabricate matches
        for patterns whose tail can consume NUL bytes."""
        import re

        from coregex_tpu.meta.engine import Engine
        e = Engine.compile(r"[ax]*[\x00b]+")
        e.batch_threshold = 0
        assert e.strategy == "full_scan"
        t = b"zzz qqq rrr a" * 3000
        assert e.is_match(t) is False
        t2 = t + b"\x00"
        assert e.is_match(t2) is True
        assert bool(re.search(rb"[ax]*[\x00b]+", t2))

    def test_size_bucket_geometry_reuse(self):
        from coregex_tpu.ops.transducer import plan_geometry, size_bucket
        # sizes in one 1/8-power-of-two bucket share one geometry
        assert plan_geometry(1_000_000) == plan_geometry(1_040_000)
        assert size_bucket(1 << 20) == 1 << 20
        for n in (1, 513, 4097, 10**6, 10**9):
            assert size_bucket(n) >= n
            assert size_bucket(n) <= max(512, n * 1.125 + 1)
