"""Conformance tables — the accelerator-build analogue of the reference's
stdlib_compat_test.go (its adaptation of Go stdlib's find_test.go tables,
SURVEY.md §4.1): a broad pattern corpus organized by construct family,
swept over a shared text corpus across find / find_all / submatch /
split / replace / count, differentially against the Go-semantics oracle
(tests/helpers.py).

Patterns re-derived from the construct families the stdlib tables cover
(literals, classes, anchors, groups, quantifiers, alternation priority,
empty matches, folds, word boundaries) — not copied; expectations come
from the oracle, with Go-vs-Python divergences handled in helpers.
"""

import pytest

from coregex_tpu.meta.engine import Engine

from helpers import (compile_oracle, go_all_matches, go_split,
                     oracle_group_bytes, oracle_groups, oracle_search)

LITERALS = [
    r"", r"a", r"ab", r"abc", r"abcdefgh", r"xyz", r"x{1}", r"zz top",
    r"\|", r"a\|b", r"\.", r"\$", r"\^", r"\(", r"\)", r"\[", r"\]",
    r"\{", r"\}", r"\\", r"a\.b", r"\+\*\?",
]

CLASSES = [
    r"[a]", r"[ab]", r"[^a]", r"[^ab]", r"[a-z]", r"[A-Z]", r"[a-zA-Z]",
    r"[0-9]", r"[^0-9]", r"[a-c-e]", r"[]a]", r"[-a]", r"[a-]",
    r"[\d]", r"[\D]", r"[\w]", r"[\W]", r"[\s]", r"[\S]",
    r"[\da-fA-F]", r"[[:alpha:]]", r"[[:digit:]]", r"[[:alnum:]]",
    r"[[:space:]]", r"[[:xdigit:]]", r"[[:lower:]]", r"[[:upper:]]",
    r"\d", r"\D", r"\w", r"\W", r"\s", r"\S", r".",
]

QUANTIFIERS = [
    r"a*", r"a+", r"a?", r"a{2}", r"a{2,}", r"a{2,4}", r"a{0,3}",
    r"a*?", r"a+?", r"a??", r"a{2,4}?",
    r"ab*", r"ab+", r"ab?", r"a*b", r"a+b", r"a?b",
    r"[ab]*", r"[ab]+", r"[^c]*", r"\d*", r"\d+", r"\d{1,3}",
    r"(ab)*", r"(ab)+", r"(ab)?", r"(ab){2}", r"(ab){1,2}",
    r"(a|b){1,3}", r"x*y*z*", r"a*a*", r"a+a*", r"(a+)(a*)",
]

ALTERNATION = [
    r"a|b", r"b|a", r"a|ab", r"ab|a", r"abc|ab|a", r"a|ab|abc",
    r"x|y|z", r"foo|bar", r"|a", r"a|", r"a|b|", r"(a|b)c",
    r"c(a|b)", r"(ab|cd)ef", r"a(x|y)b", r"one|two|three|four",
    r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH",
    r"(?:a|b)+", r"(?:ab|ba)+", r"a|aa|aaa",
]

ANCHORS = [
    r"^a", r"a$", r"^a$", r"^", r"$", r"^$", r"^abc", r"abc$", r"^abc$",
    r"\Aa", r"a\z", r"^ab*", r"a*$",
    r"(?m)^a", r"(?m)a$", r"(?m)^a$", r"(?m)^", r"(?m)$", r"(?m)^$",
    r"(?m)^abc$", r"(?m)^.*$", r"(?m)^x.*y$",
    r"\ba", r"a\b", r"\ba\b", r"\bword\b", r"\b\w+\b", r"\Ba\B",
    r"\b", r"\B", r"\b.", r".\b",
]

GROUPS = [
    r"(a)", r"(a)(b)", r"(a)|(b)", r"(a(b))", r"((a)(b))", r"(a)*",
    r"(a)+", r"(a)?", r"(a+)(b+)", r"(a*)(b*)", r"(a?)(b?)",
    r"(a|b)*c", r"x(y|z)w", r"(foo)?bar", r"foo(bar)?", r"(x)(y)?(z)",
    r"(?:a)(b)", r"(?P<n>a+)", r"(?P<a>x)(?P<b>y)",
    r"(\w+)=(\w+)", r"(\d+)\.(\d+)", r"a(bc)*d", r"((a|b)(c|d))",
]

FLAGS_AND_FOLD = [
    r"(?i)a", r"(?i)abc", r"(?i)[a-f]+", r"(?i)hello",
    r"(?i)(?:yes|no)", r"(?i)a(?-i)b", r"(?s).", r"(?s).*", r"(?s)a.b",
    r"(?i)^mixed$", r"(?U)a+", r"(?U)a+?",
]

REALISTIC = [
    r"\d+\.\d+\.\d+\.\d+", r"[\w.+-]+@[\w.-]+\.[\w.-]+",
    r"\w+://[^\s]+", r"(?m)^/.*\.php", r".*\.txt", r".*keyword.*",
    r"(\w{2,8})+", r"[a-zA-Z]+[0-9]+", r"\d{4}-\d{2}-\d{2}",
    r"(\d{1,3}\.){3}\d{1,3}", r'"[^"]*"', r"<[^>]+>", r"#\w+",
    r"[A-Z][a-z]+", r"\$\d+(\.\d{2})?", r"0x[0-9a-fA-F]+",
]

ALL_PATTERNS = (LITERALS + CLASSES + QUANTIFIERS + ALTERNATION + ANCHORS
                + GROUPS + FLAGS_AND_FOLD + REALISTIC)

TEXTS = [
    b"", b"a", b"b", b"c", b"aa", b"ab", b"ba", b"abb", b"aab", b"abc",
    b"abcabc", b"aaa", b"aaaa", b"abab", b"xyz", b"xayaz", b"x",
    b"hello world", b"Hello World", b"HELLO WORLD", b"mixed", b"MiXeD",
    b"foo bar baz", b"foobar", b"barfoo", b"one two three four",
    b"a b c", b" a ", b"  ", b"\t\n", b"\n", b"a\n", b"\na", b"a\nb",
    b"line1\nline2\nline3", b"x\n\ny", b"\n\n",
    b"192.168.0.1", b"1.2.3.4 and 10.0.0.255", b"999.1", b"...",
    b"user@example.com", b"a@b.c", b"@", b"x@y",
    b"https://ex.com/p?q=1", b"GET /index.php HTTP/1.1",
    b"/index.php\n/home/www.php", b"file.txt notes.log",
    b"keyword here", b"the keyword", b"keywor",
    b"2024-03-01", b"0xDEADbeef 0x1", b'say "quoted" end',
    b"<tag>body</tag>", b"#hash #tags", b"$5 $12.34",
    b"word1 word22 w3", b"yes NO Yes nO", b"spam ham",
    b"a=1 b=22 c=333", b"aXbXc", b"zz top zz",
    b"caf\xc3\xa9 na\xc3\xafve", b"\xce\xb1\xce\xb2 ab",
    b"\x00\x01\xff", b"aaab", b"abbb",
]


@pytest.mark.parametrize("pattern", ALL_PATTERNS)
def test_find_findall_count(pattern):
    try:
        rx = compile_oracle(pattern)
    except Exception:
        pytest.skip("oracle cannot express pattern")
    eng = Engine.compile(pattern)
    for data in TEXTS:
        if rb"\B" in pattern.encode() and data == b"":
            continue  # Go: \B matches empty text; Python re does not
        exp = oracle_search(rx, data)
        got = eng.find_index(data)
        assert got == exp, (
            f"find p={pattern!r} t={data!r}: {got} vs {exp}")
        exp_all = go_all_matches(rx, data)
        got_all = eng.find_all_index(data) or []
        assert got_all == exp_all, (
            f"find_all p={pattern!r} t={data!r}: {got_all} vs {exp_all}")
        assert eng.count(data) == len(exp_all), (
            f"count p={pattern!r} t={data!r}")


@pytest.mark.parametrize("pattern", [p for p in GROUPS + REALISTIC
                                     if "(" in p])
def test_submatch_tables(pattern):
    try:
        rx = compile_oracle(pattern)
    except Exception:
        pytest.skip("oracle cannot express pattern")
    eng = Engine.compile(pattern)
    for data in TEXTS:
        exp = oracle_groups(rx, data)
        got = eng.find_submatch_index(data)
        assert got == exp, (
            f"submatch p={pattern!r} t={data!r}: {got} vs {exp}")


@pytest.mark.parametrize("pattern", [r" ", r"\s+", r"[,;]", r"a", r"a*",
                                     r"\d+", r"", r"\b"])
def test_split_tables(pattern):
    try:
        rx = compile_oracle(pattern)
    except Exception:
        pytest.skip("oracle cannot express pattern")
    eng = Engine.compile(pattern)
    for data in TEXTS:
        if rb"\b" in pattern.encode() and data == b"":
            continue
        exp = go_split(rx, data)
        got = eng.split(data)
        assert got == exp, (
            f"split p={pattern!r} t={data!r}: {got} vs {exp}")


REPLACE_CASES = [
    (r"(\w+)=(\w+)", b"$2=$1"),
    (r"(\d+)", b"<$1>"),
    (r"a+", b"-"),
    (r"(a)(b)?", b"[$1|$2]"),
    (r"\s+", b"_"),
]


@pytest.mark.parametrize("pattern,repl", REPLACE_CASES)
def test_replace_tables(pattern, repl):
    """ReplaceAll with $-expansion vs a re.sub-based oracle built on the
    same Go allMatches loop."""
    rx = compile_oracle(pattern)
    eng = Engine.compile(pattern)
    for data in TEXTS:
        spans = go_all_matches(rx, data)
        out = bytearray()
        last = 0
        for s, e in spans:
            groups = oracle_group_bytes(rx, data, s, e) or []
            # align oracle groups to Go $-expansion
            rep = bytearray()
            i = 0
            while i < len(repl):
                ch = repl[i:i + 1]
                if ch == b"$" and i + 1 < len(repl):
                    nxt = repl[i + 1:i + 2]
                    if nxt.isdigit():
                        gi = int(nxt)
                        g = groups[gi] if gi < len(groups) else None
                        rep += g or b""
                        i += 2
                        continue
                rep += ch
                i += 1
            out += data[last:s] + bytes(rep)
            last = e
        out += data[last:]
        got = eng.replace_all(data, repl)
        assert got == bytes(out), (
            f"replace p={pattern!r} t={data!r}: {got} vs {bytes(out)}")
