"""Differential conformance: engine vs Python-re oracle with Go semantics.

The accelerator-build analogue of the reference's stdlib_compat_test.go +
fuzz_stdlib_test.go corpora (SURVEY.md §4.1-4.2): every pattern/text pair is
checked for identical spans across find / find_all / submatch / split.
"""

import pytest

from coregex_tpu.meta.engine import Engine

from helpers import (compile_oracle, go_all_matches, go_split,
                     oracle_groups, oracle_search)

# (pattern, [texts]) — pattern corpus modeled on the reference's fuzz seeds
# (fuzz_stdlib_test.go:7-60) plus accelerator-build edge cases.
PATTERNS = [
    r"abc",
    r"a",
    r"a+",
    r"a*",
    r"a?",
    r"a*?",
    r"a+?",
    r"a??",
    r"(a|b)*",
    r"a|ab",
    r"ab|a",
    r"abc|abcd|ab",
    r"[a-z]+",
    r"[^a-z]+",
    r"[0-9a-fA-F]+",
    r"\d+",
    r"\d*",
    r"\w+",
    r"\s+",
    r"\S+",
    r"\W+",
    r"\D+",
    r"a{2,4}",
    r"a{3}",
    r"a{2,}",
    r"(ab){1,3}",
    r"foo(bar)?baz",
    r"(a+)(b+)",
    r"(a(b(c)))d",
    r"(?:abc)+",
    r"x(y|z)*w",
    r"\d+\.\d+\.\d+\.\d+",
    r"\d+\.\d+",
    r"[a-zA-Z]+[0-9]+",
    r"(foo|bar|baz)",
    r"hello|world|test|data",
    r"^abc",
    r"^a+b",
    r"(?m)^b",
    r"(?m)^.*$",
    r"(?m)^/.*\.php",
    r"\bfoo\b",
    r"\bword\b",
    r"\B\d+\B",
    r"(?i)hello",
    r"(?i)[a-f]+",
    r"(?s).+",
    r".+",
    r".*",
    r"(?i)(?:spam|ham)+",
    r"a.c",
    r"a.*c",
    r"a.*?c",
    r"(a*)*",
    r"(a|)+",
    r"()",
    r"(|a)",
    r"x*y*z*",
    r"[[:alpha:]]+",
    r"[[:digit:]]+",
    r"[\d\s]+",
    r"[^\d]+",
    r"ab*c",
    r"colou?r",
    r"(\w+)@(\w+)\.com",
    r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}",
    r"a$|b",
    r"error|warning|info",
    r"GET|POST|PUT|DELETE",
]

TEXTS = [
    "",
    "a",
    "b",
    "aa",
    "ab",
    "abc",
    "abcd",
    "aabbcc",
    "xxabcyy",
    "hello world",
    "Hello World",
    "HELLO",
    "foo bar baz",
    "foobarbaz",
    "the word is here",
    "aword1 word words",
    "192.168.0.1",
    "ip 10.0.0.255 and 1.2.3.4 done",
    "ver 1.2.3",
    "a1b2c3",
    "   spaced   out   ",
    "line1\nline2\nline3",
    "a\nb\nc",
    "/index.php\n/home/user.php\n/x.txt",
    "user@example.com mail",
    "GET /path POST /other",
    "error: something warning: else",
    "aaaa",
    "abababab",
    "xyzw",
    "xw",
    "café naïve",
    "αβγ abc 123",
    "\x00\x01binary\xff",
    "spamhamspam",
    "no digits here",
    "123 456 789",
    "a.c abc a,c",
    "colour color colr",
]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_find_and_findall(pattern):
    eng = Engine.compile(pattern)
    rx = compile_oracle(pattern)
    for text in TEXTS:
        data = text.encode("utf-8")
        exp = oracle_search(rx, data)
        got = eng.find_index(data)
        assert got == exp, (
            f"find_index mismatch p={pattern!r} t={text!r}: "
            f"got {got} want {exp}")
        exp_all = go_all_matches(rx, data)
        got_all = eng.find_all_index(data) or []
        assert got_all == exp_all, (
            f"find_all mismatch p={pattern!r} t={text!r}: "
            f"got {got_all} want {exp_all}")


CAPTURE_PATTERNS = [
    r"(a+)(b+)",
    r"(a(b(c)))d",
    r"foo(bar)?baz",
    r"(\w+)@(\w+)\.com",
    r"(|a)",
    r"x(y|z)*w",
    r"(ab){1,3}",
    r"(a*)(b*)",
    r"(?P<x>a+)(?P<y>b+)",
]


@pytest.mark.parametrize("pattern", CAPTURE_PATTERNS)
def test_submatch(pattern):
    py_pat = pattern.replace("(?P<", "(?P<")  # same syntax in python
    eng = Engine.compile(pattern)
    rx = compile_oracle(py_pat)
    for text in TEXTS:
        data = text.encode("utf-8")
        exp = oracle_groups(rx, data)
        got = eng.find_submatch_index(data)
        assert got == exp, (
            f"submatch mismatch p={pattern!r} t={text!r}: "
            f"got {got} want {exp}")


@pytest.mark.parametrize("pattern", [r"\s+", r",", r"[,;]", r"a*",
                                     r"\d", r"x"])
def test_split(pattern):
    eng = Engine.compile(pattern)
    rx = compile_oracle(pattern)
    for text in TEXTS:
        data = text.encode("utf-8")
        exp = go_split(rx, data)
        got = eng.split(data)
        assert got == exp, (
            f"split mismatch p={pattern!r} t={text!r}: got {got} want {exp}")


def test_count_matches_findall():
    eng = Engine.compile(r"\w+")
    rx = compile_oracle(r"\w+")
    for text in TEXTS:
        data = text.encode("utf-8")
        assert eng.count(data) == len(go_all_matches(rx, data))


# Go-specific semantics (differ from Python re) — hand-written gold.
def test_dollar_is_absolute_end():
    # Go: `a$` does NOT match "a\n"
    eng = Engine.compile(r"a$")
    assert eng.find_index(b"a\n") is None
    assert eng.find_index(b"xa") == (1, 2)


def test_empty_match_after_nonempty_suppressed():
    # Go: `a*` over "baa" yields ["", "aa"], not Python's ["", "aa", ""]
    eng = Engine.compile(r"a*")
    assert eng.find_all_index(b"baa") == [(0, 0), (1, 3)]


def test_empty_match_advance_by_rune():
    # empty-match advance steps one UTF-8 rune, not one byte
    eng = Engine.compile(r"x*")
    spans = eng.find_all_index("héllo".encode("utf-8"))
    # h(1) é(2) l l o -> empty matches at byte offsets 0,1,3,4,5,6
    assert spans == [(0, 0), (1, 1), (3, 3), (4, 4), (5, 5), (6, 6)]


def test_posix_longest():
    eng = Engine.compile(r"a|ab", longest=True)
    assert eng.find_index(b"ab") == (0, 2)  # leftmost-longest
    eng2 = Engine.compile(r"a|ab")
    assert eng2.find_index(b"ab") == (0, 1)  # leftmost-first


def test_replace_all_with_groups():
    eng = Engine.compile(r"(\w+)=(\w+)")
    out = eng.replace_all(b"a=1 b=2", b"$2=$1")
    assert out == b"1=a 2=b"
    out2 = eng.replace_all(b"a=1", b"${1}x")
    assert out2 == b"ax"


def test_replace_all_func_and_literal():
    eng = Engine.compile(r"\d+")
    assert eng.replace_all_func(b"a1b22c", lambda m: m * 2) == b"a11b2222c"
    eng2 = Engine.compile(r"\d")
    assert eng2.replace_all_literal(b"a1b2", b"$0") == b"a$0b$0"


def test_repeated_group_empty_iteration_documented_divergence():
    """Repeated capture groups with a trailing *empty* iteration: stdlib
    captures the final empty iteration; like the reference (documented in
    its STDLIB_COMPATIBILITY.md §2 "Repeated Capture Groups"), we capture
    the last non-empty iteration.  Span is identical either way."""
    eng = Engine.compile(r"(a|)+")
    got = eng.find_submatch_index(b"a")
    assert got[0] == (0, 1)          # overall span matches stdlib
    assert got[1] in [(0, 1), (1, 1)]  # stable, documented behavior


def test_named_groups():
    eng = Engine.compile(r"(?P<year>\d{4})-(?P<month>\d{2})")
    assert eng.subexp_names() == ["", "year", "month"]
    g = eng.find_submatch(b"on 2024-03-01")
    assert g == [b"2024-03", b"2024", b"03"]


def test_anchored_literal_shapes():
    # ^prefix.*suffix$ family: O(1) byte-ops path (meta/anchored_literal.go)
    cases = [
        (r"^GET /index\.html$", b"GET /index.html", True),
        (r"^GET /index\.html$", b"GET /index.htm", False),
        (r"^foo.*bar$", b"fooxxxbar", True),
        (r"^foo.*bar$", b"fooxxx\nbar", False),   # . excludes \n
        (r"(?s)^foo.*bar$", b"fooxxx\nbar", True),
        (r"^foo.*bar$", b"fobar", False),
        (r"^a[0-9]+z$", b"a123z", True),
        (r"^a[0-9]+z$", b"az", False),
        (r"^a[0-9]*z$", b"az", True),
        (r"^abc$", b"abc", True),
        (r"^abc$", b"abcd", False),
    ]
    for pat, text, want in cases:
        eng = Engine.compile(pat)
        assert eng._anchored_lit is not None, f"{pat}: not detected"
        assert eng.is_match(text) == want, f"{pat} on {text!r}"
        if want:
            assert eng.find_index(text) == (0, len(text))


def test_config_and_debug():
    from coregex_tpu.meta.config import Config
    eng = Engine.compile(r"\d+", config=Config(enable_dfa=False))
    assert eng.fwd is None
    assert eng.find_index(b"ab 123") == (3, 6)
    import pytest as _pytest
    with _pytest.raises(ValueError):
        Config(state_limit=2).validate()
