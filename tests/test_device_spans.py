"""Device-resident span assembly (find_all_spans_device): aligned
start/end mask pairs + stream compaction, validated against the host
engine's exact Go walk."""

import sys

import numpy as np
import pytest

import jax

from coregex_tpu.meta.engine import Engine


def _base(size=250_000):
    sys.path.insert(0, ".")
    from bench import build_base
    return build_base(size)


BASE = _base()
ARR = np.frombuffer(BASE, dtype=np.uint8)

DEVICE_CASES = [
    r"\w+", r"(\w{2,8})+", r"error", r"keyword",
    r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH",
    r"error|warning|notice|info|debug",
    r".*keyword.*", r".*\.txt", r"(?m)^/.*\.php",
    r"\d+\.\d+\.\d+\.\d+",
]


@pytest.mark.parametrize("pat", DEVICE_CASES)
def test_device_spans_match_host(pat):
    e = Engine.compile(pat)
    e.batch_threshold = 0
    h = Engine.compile(pat)
    h.batch_threshold = 1 << 60
    be = e.batch_engine()
    r = be.find_all_spans_device(ARR)
    want = h._all_spans(ARR)
    assert r is not None, (pat, be.plan.strategy)
    spans_dev, cnt = r
    got = [(int(a), int(b))
           for a, b in np.asarray(jax.device_get(spans_dev[:cnt]))]
    assert got == want, (pat, len(got), len(want))


@pytest.mark.parametrize("pat", DEVICE_CASES)
def test_host_api_routes_through_device(pat):
    """find_all_spans (host API) must return identical spans whether it
    fetched from the device assembly or walked the legacy pipeline."""
    e = Engine.compile(pat)
    e.batch_threshold = 0
    h = Engine.compile(pat)
    h.batch_threshold = 1 << 60
    got = e._all_spans(ARR)
    assert got == h._all_spans(ARR), pat


def test_overlapping_candidates_fall_back_exactly():
    """Patterns whose verified candidates overlap (version-style on
    10x20x30 tokens) must detect it on device and fall back to the host
    selection walk with exact results."""
    pat = r"\d+.\d+.\d+"
    e = Engine.compile(pat)
    e.batch_threshold = 0
    h = Engine.compile(pat)
    h.batch_threshold = 1 << 60
    assert e._all_spans(ARR) == h._all_spans(ARR)


def test_self_overlapping_literal_falls_back():
    data = b"aaaa baba aa" * 2000
    arr = np.frombuffer(data, dtype=np.uint8)
    e = Engine.compile("aa")
    e.batch_threshold = 0
    be = e.batch_engine()
    assert be.find_all_spans_device(arr) is None
    h = Engine.compile("aa")
    h.batch_threshold = 1 << 60
    assert e._all_spans(arr) == h._all_spans(arr)


def test_line_shape_eot_line():
    """A final line without trailing newline still terminates at EOT."""
    data = b"x.txt\nother\nlast.txt"
    arr = np.frombuffer(data, dtype=np.uint8)
    e = Engine.compile(r".*\.txt")
    e.batch_threshold = 0
    be = e.batch_engine()
    r = be.find_all_spans_device(arr)
    # tiny corpora may route anywhere; the host API must stay exact
    h = Engine.compile(r".*\.txt")
    h.batch_threshold = 1 << 60
    assert e._all_spans(arr) == h._all_spans(arr) == [(0, 5), (12, 20)]
    del r


def test_fuzz_line_shapes_vs_host():
    rng = np.random.default_rng(41)
    words = [b"foo.txt", b"a.php", b"keyword", b"zz", b"/idx.php",
             b".txt", b"php"]
    for trial in range(6):
        lines = []
        for _ in range(200):
            k = int(rng.integers(0, 5))
            lines.append(b" ".join(
                words[int(rng.integers(len(words)))] for _ in range(k)))
        data = b"\n".join(lines) + (b"\n" if trial % 2 else b"")
        arr = np.frombuffer(data, dtype=np.uint8)
        for pat in (r".*\.txt", r"(?m)^/.*\.php", r".*keyword.*"):
            e = Engine.compile(pat)
            e.batch_threshold = 0
            h = Engine.compile(pat)
            h.batch_threshold = 1 << 60
            assert e._all_spans(arr) == h._all_spans(arr), (trial, pat)


def test_go_select_device_fuzz():
    """Device fixed-point selection == host greedy walk on adversarial
    overlap chains (kill/revive alternations)."""
    import jax.numpy as jnp
    from coregex_tpu.meta.batch import go_select
    from coregex_tpu.ops.span_kernels import go_select_device
    rng = np.random.default_rng(77)
    for t in range(120):
        M = int(rng.integers(1, 60))
        starts = np.sort(
            rng.choice(2000, size=M, replace=False)).astype(np.int32)
        ends = (starts + rng.integers(1, 40, size=M)).astype(np.int32)
        cap = 64
        fs = np.full(cap, 2**31 - 1, np.int32)
        fs[:M] = starts
        fe = np.zeros(cap, np.int32)
        fe[:M] = ends
        sel, ok = go_select_device(jnp.asarray(fs), jnp.asarray(fe),
                                   M, cap)
        assert ok, t
        selm = np.asarray(jax.device_get(sel))[:M]
        got = np.stack([starts[selm], ends[selm]], axis=1)
        want = go_select(starts.astype(np.int64), ends.astype(np.int64),
                         3000, np.zeros(3000, np.uint8))
        assert np.array_equal(got, want), t


def test_version_pattern_device_path():
    """Overlapping verified candidates (10x20x30 chains) now resolve on
    device through the fixed-point selection."""
    pat = r"\d+.\d+.\d+"
    e = Engine.compile(pat)
    e.batch_threshold = 0
    h = Engine.compile(pat)
    h.batch_threshold = 1 << 60
    be = e.batch_engine()
    r = be.find_all_spans_device(ARR)
    assert r is not None
    sd, cnt = r
    got = [(int(a), int(b))
           for a, b in np.asarray(jax.device_get(sd[:cnt]))]
    assert got == h._all_spans(ARR)


class TestInnerDeviceSpans:
    """INNER family via class-run prefixes + suffix reset-scan
    (email/url shapes) — exact vs the host walk, including the
    adversarial cases that killed naive leftmost-only pipelines."""

    EMAIL = r"[\w.+-]+@[\w.-]+\.[\w.-]+"
    URL = r"\w+://[^\s]+"

    def _chk(self, pat, data):
        arr = np.frombuffer(data, dtype=np.uint8)
        e = Engine.compile(pat)
        e.batch_threshold = 0
        h = Engine.compile(pat)
        h.batch_threshold = 1 << 60
        want = h._all_spans(arr)
        be = e.batch_engine()
        r = be.find_all_spans_device(arr)
        if r is not None:
            sd, cnt = r
            got = [(int(a), int(b))
                   for a, b in np.asarray(jax.device_get(sd[:cnt]))]
            assert got == want, (pat, data[:60])
        # host API must be exact either way
        assert e._all_spans(arr) == want, (pat, data[:60])
        return r is not None

    def test_bench_shapes_on_base(self):
        assert self._chk(self.EMAIL, BASE)
        assert self._chk(self.URL, BASE)

    def test_mid_run_start_after_prev_end(self):
        # prev match ends inside the next candidate's start run: Go
        # restarts mid-run; the flexible-interval selection must emit
        # max(leftmost, prev_end)
        assert self._chk(r"\w+@\w+", b"a@b+c@d x") is not None

    def test_eoi_suffix(self):
        for data in (b"a@b", b"joe@x.com", b"no.dot@nodomain and x@y.z",
                     b"pre a@b"):
            self._chk(r"\w+@\w+", data)
            self._chk(self.EMAIL, data)

    def test_nested_candidate_interference_falls_back(self):
        # a second "://" inside the first URL's suffix run: interference
        # detected on device, host walk stays exact
        data = b"see http://x.com/r?u=https://y.com done"
        arr = np.frombuffer(data, dtype=np.uint8)
        e = Engine.compile(self.URL)
        e.batch_threshold = 0
        h = Engine.compile(self.URL)
        h.batch_threshold = 1 << 60
        assert e._all_spans(arr) == h._all_spans(arr)

    def test_bounded_prefix_repeats(self):
        self._chk(r"\w{2,4}@\w+", b"toolong12345@x yy@z a@b")
        self._chk(r"\w{2,}@\w+", b"abcde@x y@z")

    def test_structured_fuzz(self):
        rng = np.random.default_rng(101)
        toks = [b"a@b.c", b"xx@y", b"foo", b"@", b".", b"a@b",
                b"x@y.z@w.q", b" ", b"\n", b"u+v@d-e.f"]
        for t in range(8):
            data = b"".join(
                toks[i] for i in rng.integers(0, len(toks), size=60))
            self._chk(self.EMAIL, data)
            self._chk(r"\w+@\w+", data)


def test_prefix_run_interleaved_fuzz():
    """PREFIX_RUN verification via K-interleaved reset-scans: exact on
    token soup with dense overlapping candidates and EOI-ending
    matches (each subset's final interval can silently reach EOI)."""
    rng = np.random.default_rng(7)
    toks = [b"1.2.3", b"10x20x30", b"1", b".", b" ", b"\n", b"99.100",
            b"2.14.7", b"a"]
    for t in range(14):
        data = b"".join(
            toks[i] for i in rng.integers(0, len(toks), size=40))
        arr = np.frombuffer(data, np.uint8)
        for pat in (r"\d+.\d+.\d+", r"\d+\.\d+\.\d+\.\d+"):
            e = Engine.compile(pat)
            e.batch_threshold = 0
            h = Engine.compile(pat)
            h.batch_threshold = 1 << 60
            assert e._all_spans(arr) == h._all_spans(arr), (t, pat)
