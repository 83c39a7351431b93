"""Round-2 feature tests: word-repeat shape, rare-byte inner literals,
device find_first, onehot count scan, batched OnePass captures."""

import numpy as np
import pytest

from coregex_tpu.meta.engine import Engine


def _host(pattern, **kw):
    e = Engine.compile(pattern, **kw)
    e.batch_threshold = 1 << 60
    return e


def _batch(pattern, **kw):
    e = Engine.compile(pattern, **kw)
    e.batch_threshold = 0
    return e


WORDISH = (b"abc de_9 xx yzw123456789 - !longwordhere12345678 a b  "
           b"Zz 0123456789abcdef ~~ x\n") * 12


class TestWordRepeatShape:
    @pytest.mark.parametrize("pat", [
        r"(\w{2,8})+", r"(\w{3,4})+", r"([a-z]{2,2})+", r"(\w{2,})+",
        r"((\w){2,8})+", r"(\w{1,3})+",
    ])
    def test_spans_match_host(self, pat):
        arr = np.frombuffer(WORDISH, dtype=np.uint8)
        host = _host(pat)._all_spans(arr)
        b = _batch(pat)
        assert b.strategy == "charclass"
        assert b._all_spans(arr) == host
        assert b.count(arr) == len(host)

    def test_plus_shape_detection(self):
        from coregex_tpu.meta.literal import charclass_shape
        from coregex_tpu.syntax.parser import parse
        cc = charclass_shape(parse(r"(\w{2,8})+").ast)
        assert cc is not None and cc.plus and cc.min == 2 and cc.max == 8
        cc = charclass_shape(parse(r"(\w{2,})+").ast)
        assert cc is not None and not cc.plus and cc.min == 2
        assert charclass_shape(parse(r"(\w{2,8})+?").ast) is None


EMAILISH = (b"hello user@example.com world visit https://ex.com/x?a=1 "
            b"now v1.2.3 and 10.0.0.255 or a@b.c@d.ee plain @ alone "
            b"x@y.z end\n") * 12


class TestRareByteInner:
    @pytest.mark.parametrize("pat,strategy", [
        (r"[\w.+-]+@[\w.-]+\.[\w.-]+", "inner"),
        (r"\w+://[^\s]+", "inner"),
    ])
    def test_email_url(self, pat, strategy):
        arr = np.frombuffer(EMAILISH, dtype=np.uint8)
        b = _batch(pat)
        assert b.strategy == strategy
        host = _host(pat)._all_spans(arr)
        assert b._all_spans(arr) == host
        assert b.count(arr) == len(host)

    def test_rare_byte_table(self):
        from coregex_tpu.meta.literal import is_rare_byte
        assert is_rare_byte(ord("@"))
        assert not is_rare_byte(ord("e"))
        assert not is_rare_byte(ord(" "))
        assert not is_rare_byte(ord("."))


class TestFindFirstDevice:
    PATTERNS = [
        (r"keyword", EMAILISH),
        (r"error|warning|alone", EMAILISH),
        (r"[\w]+", WORDISH),
        (r"(\w{2,8})+", WORDISH),
        (r"\d+\.\d+", EMAILISH),
        (r"[\w.+-]+@[\w.-]+\.[\w.-]+", EMAILISH),
        (r".*@.*", EMAILISH),
        (r"zzzznotthere", EMAILISH),
    ]

    @pytest.mark.parametrize("pat,text", PATTERNS)
    def test_find_index_matches_host(self, pat, text):
        arr = np.frombuffer(text, dtype=np.uint8)
        want = _host(pat)._find_span_host(arr, 0)
        b = _batch(pat)
        from coregex_tpu.meta.batch import FALLBACK
        m = b.batch_engine().find_first(arr) \
            if b.strategy != "host" else want
        if m is FALLBACK:
            m = want
        assert m == want
        assert b.find_index(text) == want

    def test_find_offsets_tail(self):
        # match only near the end: prefix escalation must keep scanning
        text = b"x" * 5000 + b"needle" + b"y" * 10
        arr = np.frombuffer(text, dtype=np.uint8)
        b = _batch(r"needle.*")
        assert b.find_index(arr) == (5000, 5016)


class TestOnehotCountImpl:
    def test_onehot_matches_host(self):
        """The count transducer (the impl that replaced the one-hot
        step) against the host walk."""
        import jax.numpy as jnp

        from coregex_tpu.dfa.countdfa import build_count_dfa
        from coregex_tpu.dfa.determinize import determinize
        from coregex_tpu.nfa.thompson import compile_nfa
        from coregex_tpu.ops.count_scan import CountScanner
        text = (b"v1.2.3 10.0.0.255 x 192.168.1.10 hi 2.14.7 99 a.b.c "
                b"5.6 7.8.9x\n") * 40
        arr = np.frombuffer(text, dtype=np.uint8)
        e = _host(r"\d+.\d+.\d+")
        host = len(e._all_spans(arr))
        nfa = compile_nfa(e.parsed, with_captures=False)
        cd = build_count_dfa(
            determinize(nfa, anchored=False, break_at_match=True))
        sc = CountScanner(cd)
        assert sc.count(jnp.asarray(arr)) == host


class TestBatchedOnePass:
    def test_captures_match_host(self):
        text = (b"a12-foo b345-xy c6-zz q99-abc k1-m " * 20 + b"\n") * 4
        arr = np.frombuffer(text, dtype=np.uint8)
        e = _host(r"(\d+)-(\w+)")
        spans = e._all_spans(arr)
        assert len(spans) >= 64
        got = e._batch_captures(arr, spans)
        assert all(g is not None for g in got)
        for (s, ee), g in zip(spans, got):
            ref = e._captures_in_span(arr, bytes(text), (s, ee))
            assert tuple(g) == tuple(ref)

    def test_find_all_submatch_index(self):
        text = (b"a12-foo b345-xy c6-zz q99-abc k1-m " * 20 + b"\n") * 4
        e = _host(r"(\d+)-(\w+)")
        ref = Engine.compile(r"(\d+)-(\w+)")
        ref.batch_threshold = 1 << 60
        ref._batch_captures = lambda arr, spans: [None] * len(spans)
        assert e.find_all_submatch_index(text) == \
            ref.find_all_submatch_index(text)

    def test_replace_all_uses_batch(self):
        text = (b"a12-foo b345-xy c6-zz " * 30 + b"\n") * 3
        e = _host(r"(\d+)-(\w+)")
        ref = Engine.compile(r"(\d+)-(\w+)")
        ref.batch_threshold = 1 << 60
        ref._batch_captures = lambda arr, spans: [None] * len(spans)
        assert e.replace_all(text, b"[$2:$1]") == \
            ref.replace_all(text, b"[$2:$1]")

    def test_ambiguous_patterns_rejected(self):
        from coregex_tpu.dfa.onepass import NotOnePass, build_onepass
        from coregex_tpu.nfa.thompson import compile_nfa
        from coregex_tpu.syntax.parser import parse
        # two epsilon paths reach the same suffix with different slot
        # masks: (a)|(a)b family must NOT be one-pass
        for pat in [r"(a)|(a)b", r"(a?)(a?)"]:
            nfa = compile_nfa(parse(pat), with_captures=True)
            with pytest.raises(NotOnePass):
                build_onepass(nfa)

    def test_onepass_still_accepts_clean_patterns(self):
        from coregex_tpu.dfa.onepass import build_onepass
        from coregex_tpu.nfa.thompson import compile_nfa
        from coregex_tpu.syntax.parser import parse
        for pat in [r"(\d+)-(\w+)", r"(a+)(b+)"]:
            nfa = compile_nfa(parse(pat), with_captures=True)
            assert build_onepass(nfa) is not None
