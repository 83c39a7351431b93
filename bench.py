"""Benchmark harness: ALL 12 of the reference's headline configs
(README.md:68-79) on the reference's 6 MB-class corpus, tiled up so the
per-call device sync amortizes away.  Runs on the GPU only.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N}

vs_baseline = geometric mean over configs of (reference_ms / our_ms) using
the reference's published 6 MB numbers (BASELINE.md; README.md:68-79) —
values > 1 mean faster than the reference on its own benchmarks.
Details per config go to stderr.

Parity is verified in-bench: the corpus is an exact line-aligned tiling of
a 6 MB base, and every headline pattern is newline-bounded (no match can
cross a tile seam), so the exact expected count is reps * oracle(base)
with Python re as the oracle (identical leftmost-first semantics on these
ASCII, non-empty-match patterns).  A mismatch marks the config FAIL and
the summary metric "[PARITY FAIL]".
"""

import json
import math
import os
import re
import sys
import time

import numpy as np

# Wall-clock budget: emit the JSON line with whatever completed rather than
# being killed by an external timeout.
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "2400"))
_T0 = time.time()

# find_all slice policy: the sparse-chain families run at full corpus
# scale bounded by a span-count budget; the pipelines that hold
# corpus-sized int32 intermediates keep a 256 MB slice.  Both caps were
# sized for a 16 GB device and are kept as long as they run on this one.
SPAN_BUDGET = 96 * 1024 * 1024
LEGACY_SLICE = 256 * 1024 * 1024


def build_base(size=6 * 1024 * 1024, seed=7) -> bytes:
    """Log-like 6 MB base corpus: paths, IPs, emails, URLs, versions,
    HTTP verbs, keywords — modeled on the kolkov/regex-bench style input
    the reference's README numbers use.  Trimmed to the last full line so
    tiling is line-aligned (needed for the parity oracle)."""
    rng = np.random.default_rng(seed)
    words = [
        b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
        b"dog", b"lorem", b"ipsum", b"dolor", b"sit", b"amet", b"consec",
        b"GET", b"POST", b"HTTP/1.1", b"200", b"404", b"useragent",
        b"alpha", b"beta", b"gamma", b"delta42", b"x86_64", b"warning",
    ]
    specials = [
        b"192.168.1.10", b"10.0.0.255", b"error", b"keyword",
        b"user@example.com", b"admin@test.org", b"v1.2.3",
        b"/index.php", b"/home/user/www.php", b"file.txt", b"notes.log",
        b"https://example.com/index.html?q=1", b"http://test.org/a/b",
        b"DELETE", b"2.14.7",
    ]
    lines = []
    total = 0
    while total < size:
        k = int(rng.integers(4, 12))
        line = []
        for _ in range(k):
            if rng.random() < 0.08:
                line.append(specials[int(rng.integers(len(specials)))])
            else:
                line.append(words[int(rng.integers(len(words)))])
        ln = b" ".join(line) + b"\n"
        lines.append(ln)
        total += len(ln)
    base = b"".join(lines)[:size]
    return base[:base.rfind(b"\n") + 1]


ALT32 = "|".join(
    ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
     "lambda", "sigma", "omega", "error", "warning", "notice", "debug",
     "trace", "fatal", "panic", "abort", "retry", "timeout", "refused",
     "closed", "opened", "created", "deleted", "updated", "inserted",
     "removed", "flushed", "synced", "loaded", "stored"])

# (name, pattern, reference ms for 6 MB, source) — one row per reference
# headline class (README.md:68-79 / BASELINE.md) + the single-literal
# Teddy-throughput headline (README.md:231).
CONFIGS = [
    ("inner_keyword", r".*keyword.*", 0.26, "README.md:68"),
    ("ip", r"\d+\.\d+\.\d+\.\d+", 0.77, "README.md:69"),
    ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+", 0.55, "README.md:70"),
    ("url", r"\w+://[^\s]+", 0.61, "README.md:71"),
    ("multiline_php", r"(?m)^/.*\.php", 0.38, "README.md:72"),
    ("version", r"\d+.\d+.\d+", 0.65, "README.md:73"),
    ("suffix_txt", r".*\.txt", 1.79, "README.md:74"),
    ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH", 1.51,
     "README.md:75"),
    ("alt_literal", r"error|warning|notice|info|debug", 4.69,
     "README.md:76"),
    ("multi_literal32", ALT32, 12.9, "README.md:77"),
    ("charclass_w", r"[\w]+", 41.9, "README.md:78"),
    ("word_repeat", r"(\w{2,8})+", 179.0, "README.md:79"),
    ("literal_error", r"error", 0.65, "Teddy 9 GB/s, README.md:231"),
]


REF_MB = 6 * 1024 * 1024 / 1e6  # reference numbers are for 6 MB inputs


def oracle_count(pattern: str, base: bytes) -> int:
    """Python re span count on the base tile (leftmost-first, ASCII
    classes on bytes — identical to Go semantics for every headline
    pattern: non-empty matches, no \\A/\\z, no fold)."""
    return sum(1 for _ in re.finditer(pattern.encode("ascii"), base))


def oracle_span_digest(pattern: str, base: bytes, reps: int):
    """Exact expected (count, sum-of-starts, sum-of-ends) mod 2^32 for
    the tiled corpus, computed analytically from the base tile's oracle
    spans: tile t's spans are the base spans + t*len(base) (the corpus
    is a line-aligned tiling and every pattern is newline-bounded)."""
    spans = [m.span() for m in re.finditer(pattern.encode("ascii"), base)]
    m0 = len(spans)
    s0 = sum(s for s, _ in spans)
    e0 = sum(e for _, e in spans)
    B = len(base)
    toff = B * m0 * (reps * (reps - 1) // 2)
    M = 1 << 32
    return (reps * m0, (reps * s0 + toff) % M, (reps * e0 + toff) % M)


def _dig_jit():
    # module-level jitted digest: a nested @jax.jit def would be a NEW
    # function object per call -> full retrace every call (~30 ms)
    import jax
    import jax.numpy as jnp

    @jax.jit
    def dig(spans, cnt, okx, sidx):
        cap = spans.shape[0]
        cnt = cnt.astype(jnp.int32)
        live = jnp.arange(cap, dtype=jnp.int32) < cnt
        s = jnp.where(live, spans[:, 0], 0)
        e = jnp.where(live, spans[:, 1], 0)
        ssum = s.astype(jnp.uint32).sum(dtype=jnp.uint32)
        esum = e.astype(jnp.uint32).sum(dtype=jnp.uint32)
        ok = okx & jnp.all(
            jnp.where(live, spans[:, 0] < spans[:, 1], True))
        live2 = jnp.arange(cap - 1, dtype=jnp.int32) < cnt - 1
        ok &= jnp.all(jnp.where(live2, spans[1:, 0] >= spans[:-1, 1],
                                True))
        samp = spans[jnp.minimum(sidx, cap - 1)]
        return ssum, esum, ok, samp, cnt

    return dig


_DIG = None


def span_digest_device(spans_dev, cnt, ok_dev=None, sample_idx=None):
    """One fused device reduction: wraparound sums of starts/ends over
    the first cnt spans + a strict order/non-overlap flag + the
    builder's deferred validation flag + K sampled spans — ONE scalar
    sync verifies the whole extraction without shipping the spans to
    the host (sampled spans are a few hundred bytes)."""
    global _DIG
    import jax
    import jax.numpy as jnp
    if _DIG is None:
        _DIG = _dig_jit()
    okx = jnp.bool_(True) if ok_dev is None else ok_dev
    if sample_idx is None:
        sample_idx = jnp.zeros(1, dtype=jnp.int32)
    # NOTE: pass sample_idx as a DEVICE array (device_put once, outside
    # timing loops): a host array here costs a blocking upload per call
    cnt_in = jnp.int32(cnt) if isinstance(cnt, int) else cnt
    ssum, esum, ok, samp, cnt_h = jax.device_get(
        _DIG(spans_dev, cnt_in, okx, sample_idx))
    return int(ssum), int(esum), bool(ok), np.asarray(samp), int(cnt_h)


def oracle_sample_spans(pattern, base, sample_idx):
    """Exact expected spans at the given GLOBAL match indices of the
    tiled corpus (tile t's spans are base spans + t*len(base))."""
    spans = [m.span() for m in re.finditer(pattern.encode("ascii"), base)]
    m0 = len(spans)
    B = len(base)
    out = []
    for g in sample_idx:
        t, j = divmod(int(g), m0)
        out.append((spans[j][0] + t * B, spans[j][1] + t * B))
    return np.array(out, dtype=np.int64)


def _release_device_corpora(eng):
    """Drop ALL cached device corpus buffers (incl. the full-size count
    corpus AND its int32 word-tile layout — together ~2x corpus bytes)
    so the find_all slice phase starts with clean HBM headroom; keeps
    the engine's compiled artifacts."""
    import gc
    from coregex_tpu.ops import transducer
    from coregex_tpu.utils import corpus_cache
    corpus_cache._cache.clear()
    transducer._tiles_cache.clear()
    gc.collect()


def _free_config_state(eng):
    """Release per-config device residue: the engine's DFA tables and any
    flipped corpus copies.  The forward corpus buffer and the word-tile
    layouts stay cached (shared across configs); everything else goes so
    config N+1 starts with full HBM headroom (the r2 bench died from
    accumulated residue, BENCH_r02.json)."""
    import gc
    from coregex_tpu.utils import corpus_cache
    if eng is not None:
        eng._batch = None  # drop BatchEngine (DeviceDFA/scanner tables)
    corpus_cache.release_flipped()
    gc.collect()


def main():
    import jax
    from chip_smoke import card_info, require_gpu
    from coregex_tpu.meta.engine import Engine
    from coregex_tpu.utils.compile_cache import enable_compile_cache

    # times are device times: refuse to report anything off the GPU
    require_gpu(jax.devices())
    enable_compile_cache()
    d0 = jax.devices()[0]
    print(f"card: {card_info()}; {len(jax.devices())} x {d0.device_kind}",
          file=sys.stderr)
    # a 1.5 GB corpus amortizes the per-call sync so the number reflects
    # scan throughput; vs_baseline compares per-6MB-equivalent times.
    # Device memory: corpus u8 + word tiles i32 + flipped variants ~= 4x
    # corpus bytes.
    base = build_base()
    target = int(os.environ.get("BENCH_CORPUS_MB", "1536")) * 1024 * 1024
    reps = max(1, target // len(base))
    corpus = base * reps
    n = len(corpus)
    arr = np.frombuffer(corpus, dtype=np.uint8)
    scale = (n / 1e6) / REF_MB
    check_parity = os.environ.get("BENCH_PARITY", "1") != "0"
    print(f"corpus: {n / 1e6:.1f} MB ({reps} line-aligned tiles of "
          f"{len(base)/1e6:.2f} MB)", file=sys.stderr)

    ratios = []
    gbps_all = []
    fa_ratios = []
    fa_gbps_all = []
    results = {}
    engines = {}
    parity_all = True
    failures = []

    # ---- Phase 1: counts (full corpus) --------------------------------
    # All counts run before any find_all: a device OOM poisons the
    # PROCESS (later compiles fail RESOURCE_EXHAUSTED — this vaporized
    # 12/13 configs once), and span assembly is the risky phase, so it
    # goes last.
    for name, pattern, ref_ms, src in CONFIGS:
        if time.time() - _T0 > BUDGET_S:
            print(f"  {name}: skipped (budget)", file=sys.stderr)
            continue
        eng = None
        try:
            eng = Engine.compile(pattern)
            eng.batch_threshold = 0
            t0 = time.perf_counter()
            cnt = eng.count(arr)
            warm = time.perf_counter() - t0
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                eng.count(arr)
                times.append(time.perf_counter() - t0)
            best = min(times)
        except Exception as ex:
            failures.append(name)
            print(f"  {name:16} FAILED: {type(ex).__name__}: "
                  f"{str(ex)[:200]}", file=sys.stderr)
            results[name] = dict(error=f"{type(ex).__name__}: "
                                 f"{str(ex)[:200]}")
            _free_config_state(eng)
            continue
        m0 = oracle_count(pattern, base)
        if check_parity:
            expect = reps * m0
            ok = (cnt == expect)
        else:
            expect = None
            ok = True
        gbps = n / best / 1e9
        per6_ms = best * 1e3 / scale
        ratio = ref_ms / per6_ms
        ratios.append(ratio)
        gbps_all.append(gbps)
        results[name] = dict(ms=best * 1e3, per6_ms=per6_ms, gbps=gbps,
                             ref_ms=ref_ms, vs_ref=ratio, count=cnt,
                             expect=expect, strategy=eng.strategy,
                             parity=ok, findall_ms=None,
                             findall_gbps=None, findall_vs_ref=None,
                             findall_mode="none")
        engines[name] = (eng, m0, ok)
        parity_all = parity_all and ok
        print(f"  {name:16} {best*1e3:8.2f} ms ({per6_ms:7.2f}/6MB)"
              f"  {gbps:7.2f} GB/s  vs_ref {ratio:6.2f}x"
              f"  n={cnt} [{eng.strategy}] warm={warm:.1f}s"
              f"  {'ok' if ok else 'PARITY FAIL exp=%s' % expect}",
              file=sys.stderr)
        _free_config_state(eng)

    # ---- Phase 2: find_all (density-adaptive slices) ------------------
    # The reference's headline numbers time match EXTRACTION
    # (README.md:68-79): spans assemble on device, parity via analytic
    # tiled checksums + 64 sampled spans compared byte-exactly, one
    # scalar sync.  Slices: SPAN_BUDGET / LEGACY_SLICE above.
    for name, pattern, ref_ms, src in CONFIGS:
        if name not in engines:
            continue
        if time.time() - _T0 > BUDGET_S:
            print(f"  {name}: findall skipped (budget)", file=sys.stderr)
            continue
        eng, m0, ok = engines[name]
        fa_ms = fa_gbps = fa_ratio = None
        fa_ok = True
        fa_mode = "none"
        try:
            be = eng.batch_engine()
            strat = be.plan.strategy
            sparse_fam = strat.name in be._SPARSE_FAMILIES
            fam_limit = (be._spans_limit(strat) if sparse_fam
                         else min(be._spans_limit(strat), LEGACY_SLICE))
        except Exception:
            fam_limit = LEGACY_SLICE
        fa_reps = min(reps, max(1, SPAN_BUDGET // max(m0, 1)),
                      max(1, fam_limit // len(base)))
        fa_arr = arr[:fa_reps * len(base)]
        fa_n = len(fa_arr)
        _release_device_corpora(eng)
        try:
            r = be.find_all_spans_device(fa_arr, defer_ok=True)
            if r is not None:
                rng_s = np.random.default_rng(123)
                sd, fcnt, okd = r
                fcnt_h = (int(jax.device_get(fcnt))
                          if not isinstance(fcnt, int) else fcnt)
                sidx_h = (rng_s.integers(0, max(fcnt_h, 1), 64)
                          .astype(np.int32))
                import jax.numpy as _jnp
                sidx = jax.device_put(_jnp.asarray(sidx_h))
                t0 = time.perf_counter()
                dig = span_digest_device(sd, fcnt, okd, sidx)
                _ = time.perf_counter() - t0
                times = []
                for _i in range(2):
                    t0 = time.perf_counter()
                    r2 = be.find_all_spans_device(fa_arr, defer_ok=True)
                    sd2, fcnt2, okd2 = r2
                    dig = span_digest_device(sd2, fcnt2, okd2, sidx)
                    times.append(time.perf_counter() - t0)
                fa_ms = min(times) * 1e3
                fa_mode = "device"
                if check_parity:
                    em, es, ee = oracle_span_digest(pattern, base,
                                                    fa_reps)
                    fa_ok = (dig[4] == em and dig[0] == es
                             and dig[1] == ee and dig[2])
                    if fa_ok and em:
                        # exact-span sampling: 64 random spans compared
                        # byte-exactly to the oracle (verdict item 7)
                        exp_s = oracle_sample_spans(pattern, base,
                                                    sidx_h)
                        fa_ok = bool((dig[3].astype(np.int64)
                                      == exp_s).all())
            else:
                t0 = time.perf_counter()
                sp = be.find_all_spans(fa_arr, -1)
                fa_ms = (time.perf_counter() - t0) * 1e3
                fa_mode = "host"
                if check_parity:
                    em, es, ee = oracle_span_digest(pattern, base,
                                                    fa_reps)
                    M = 1 << 32
                    fa_ok = (len(sp) == em
                             and int(sp[:, 0].sum()) % M == es
                             and int(sp[:, 1].sum()) % M == ee)
        except Exception as ex:  # pragma: no cover - device specific
            fa_mode = f"error:{type(ex).__name__}"
            fa_ok = False
        ok = ok and fa_ok
        parity_all = parity_all and fa_ok
        if fa_ms is not None:
            fa_scale = (fa_n / 1e6) / REF_MB
            fa_gbps = fa_n / (fa_ms / 1e3) / 1e9
            fa_ratio = ref_ms / (fa_ms / fa_scale)
            fa_ratios.append(fa_ratio)
            fa_gbps_all.append(fa_gbps)
        results[name].update(parity=ok, findall_ms=fa_ms,
                             findall_gbps=fa_gbps,
                             findall_vs_ref=fa_ratio,
                             findall_mode=fa_mode)
        print(f"  {name:16} findall "
              + (f"{fa_ms:8.1f} ms {fa_gbps:6.2f} GB/s "
                 f"vs_ref {fa_ratio:5.2f}x [{fa_mode}] "
                 f"slice={fa_n//(1024*1024)}MB"
                 if fa_ms is not None else f"[{fa_mode}]")
              + f"  {'ok' if fa_ok else 'PARITY FAIL'}",
              file=sys.stderr)
        _free_config_state(eng)

    if not gbps_all:
        print(json.dumps({"metric": "bench budget exhausted before any "
                          "config completed", "value": 0.0,
                          "unit": "GB/s", "vs_baseline": 0.0}))
        return
    geomean_gbps = math.exp(sum(math.log(g) for g in gbps_all)
                            / len(gbps_all))
    vs_baseline = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
    fa_geo = (math.exp(sum(math.log(g) for g in fa_gbps_all)
                       / len(fa_gbps_all)) if fa_gbps_all else 0.0)
    fa_vs = (math.exp(sum(math.log(r) for r in fa_ratios)
                      / len(fa_ratios)) if fa_ratios else 0.0)
    n_total = len(CONFIGS)
    print(json.dumps({
        "metric": f"geomean GB/s over {len(gbps_all)}/{n_total} reference "
                  "headline configs (6MB), count+find_all parity-checked;"
                  f" find_all {len(fa_gbps_all)}/{n_total} geomean "
                  f"{fa_geo:.2f} GB/s = {fa_vs:.2f}x ref extraction "
                  "(device-resident spans, checksum-verified)"
                  + ("" if parity_all else " [PARITY FAIL]")
                  + ("" if not failures
                     else f" [{len(failures)} failed: "
                          f"{','.join(failures)}]"),
        "value": round(geomean_gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(vs_baseline, 3),
    }))


if __name__ == "__main__":
    main()
