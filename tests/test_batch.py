"""Batch (kernel) engine vs host engine: span-exact equivalence per
strategy on synthetic corpora (the device analogue of the reference's
cross-strategy correctness matrices, meta/reverse_strategies_test.go)."""

import numpy as np
import pytest

from coregex_tpu.meta.engine import Engine
from coregex_tpu.meta.strategy import Strategy


def make_corpus(seed=0, size=60_000) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"error", b"warning", b"info", b"debug", b"the", b"quick",
             b"fox", b"keyword", b"x1y", b"10.2.3.44", b"name.php",
             b"file.txt", b"/index.php", b"GET", b"POST", b"3.14",
             b"a-b", b"_id42", b"hello", b"world"]
    parts = []
    total = 0
    while total < size:
        w = words[rng.integers(len(words))]
        parts.append(w)
        total += len(w)
        if rng.random() < 0.12:
            parts.append(b"\n")
            total += 1
        else:
            parts.append(b" ")
            total += 1
    return b"".join(parts)[:size]


CORPUS = make_corpus()

CASES = [
    (r"error", Strategy.LITERAL),
    (r"keyword", Strategy.LITERAL),
    (r"zzznotfound", Strategy.LITERAL),
    (r"error|warning|info", Strategy.MULTI_LITERAL),
    (r"GET|POST|PUT|DELETE", Strategy.MULTI_LITERAL),
    (r"[a-z]+", Strategy.CHARCLASS),
    (r"\d+", Strategy.CHARCLASS),
    (r"\w{3,}", Strategy.CHARCLASS),
    (r"[0-9]{2,3}", Strategy.CHARCLASS),
    (r".*keyword.*", Strategy.LINE_SHAPE),
    (r".*\.txt", Strategy.LINE_SHAPE),
    (r"(?m)^/.*\.php", Strategy.LINE_SHAPE),
    (r"error.*", Strategy.LINE_SHAPE),
    (r"(?s).*keyword(?s).*", Strategy.LINE_SHAPE),
    (r"error.*fox", Strategy.PREFIX_SET),
    (r"\w+\.php", Strategy.INNER),
    (r"\d+\.\d+\.\d+\.\d+", Strategy.PREFIX_RUN),
    (r"\d+\.\d+", Strategy.PREFIX_RUN),
    (r"[a-z]+[0-9]+", Strategy.PREFIX_RUN),
    (r"\bfox\b", Strategy.INNER),
]


@pytest.mark.parametrize("pattern,expected_strategy", CASES)
def test_batch_matches_host(pattern, expected_strategy):
    host = Engine.compile(pattern)
    host.batch_threshold = 1 << 62       # force host path
    batch = Engine.compile(pattern)
    batch.batch_threshold = 0            # force batch path

    assert batch.batch_engine().plan.strategy == expected_strategy, (
        f"{pattern}: got strategy {batch.batch_engine().plan.strategy} "
        f"({batch.batch_engine().plan.reason})")

    exp = host.find_all_index(CORPUS) or []
    got = batch.find_all_index(CORPUS) or []
    assert got == exp, (
        f"{pattern}: batch {len(got)} spans vs host {len(exp)}; "
        f"first diff: {next(((g, e) for g, e in zip(got, exp) if g != e), None)}")

    assert batch.is_match(CORPUS) == host.is_match(CORPUS)
    assert batch.count(CORPUS) == host.count(CORPUS)


def test_batch_find_limit():
    batch = Engine.compile(r"error")
    batch.batch_threshold = 0
    spans = batch.find_all_index(CORPUS, 3)
    assert spans is not None and len(spans) == 3


def test_small_input_uses_host():
    eng = Engine.compile(r"abc")
    assert eng.find_index(b"xxabc") == (2, 5)
    assert eng.stats.kernel_scans == 0


@pytest.mark.parametrize("pattern", [
    r"error|warning|info", r"abc|abcd|ab", r"[a-z]+", r"\d+\.\d+",
    r".*keyword.*", r"error", r"fox|foxes"])
def test_batch_posix_longest_matches_host(pattern):
    host = Engine.compile(pattern, longest=True)
    host.batch_threshold = 1 << 62
    batch = Engine.compile(pattern, longest=True)
    batch.batch_threshold = 0
    small = CORPUS[:30_000]
    exp = host.find_all_index(small) or []
    got = batch.find_all_index(small) or []
    assert got == exp, (
        f"{pattern}: POSIX batch {len(got)} vs host {len(exp)}; "
        f"first diff {next(((g, e) for g, e in zip(got, exp) if g != e), None)}")
    assert batch.count(small) == host.count(small)
