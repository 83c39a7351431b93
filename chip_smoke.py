"""Smoke test of the engine's device path on the GPU.

    python chip_smoke.py          one card: the kernel phase, then the 13
                                  bench configs end to end
    python chip_smoke.py --four   four cards: Engine.count sharded over a
                                  4 x 1536 MB corpus, against the oracle
                                  and the one-card count of that corpus

The one-card run drives the public entry points at bench.py's size (the
6 MB log base tiled to 1536 MB):

  * kernel phase: the transducer kernel in count, event and flag mode at
    the corpus's real lane geometry, each compared exactly with the
    plain XLA scan and timed beside it, with `memory_analysis()` of the
    compiled kernel step;
  * per config: `count` on the full corpus (parity: reps * oracle),
    device-resident find_all at bench's slice size (digest + 64 sampled
    spans), `find_all_index` on a 64 MB slice against Python `re` on
    that slice, and `is_match` / `find_index` on the full corpus.

Every answer is exact.  It prints the card's name and power limit, the
strategy, serving path, compile and steady time of each call, and as
its last line one JSON object {"ok": true, "device": {...}}.  It exits
non-zero and prints no result off the GPU, on any parity failure, when
a config is answered by the host loop, or when any phase raises.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_MB = 1536
INDEX_SLICE_MB = 64


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: no CPU numbers, no result."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {kind!r}")


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi unavailable: {ex}"


def _timed(fn, *a, **kw):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*a, **kw))
    return out, time.perf_counter() - t0


def _same(a, b) -> bool:
    import jax
    a, b = jax.device_get((a, b))
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.items.append(what)
            print(f"  FAIL {what}", flush=True)
        return ok


def kernel_phase(arr, fails: Failures) -> None:
    """Each transducer mode at the corpus's real geometry: triton vs the
    plain XLA scan, exact, both timed (second call)."""
    import jax
    import jax.numpy as jnp
    from coregex_tpu.dfa.dense import DEAD
    from coregex_tpu.meta.engine import Engine
    from coregex_tpu.ops import count_scan, flag_scan, span_scan
    from coregex_tpu.ops import transducer as tx
    from coregex_tpu.utils.corpus_cache import device_corpus

    n = len(arr)
    dev = device_corpus(arr)
    L, T, W = tx.plan_geometry(n)
    print(f"kernel phase: n={n} lanes={L} lane_bytes={T} warmup={W}",
          flush=True)
    be = Engine.compile(r"[\w.+-]+@[\w.-]+\.[\w.-]+").batch_engine()
    d = be._count_scanner_ascii().dcd
    tiles = tx.corpus_word_tiles(dev, L, T)
    sot = jnp.int32(int(d.cd.starts[0]))
    cases = {"count": (count_scan._count_lanes_jit,
                       (d.table, d.cmap, d.starts, dev, tiles,
                        jnp.int32(n), sot),
                       dict(L=L, T=T, W=W, C=d.C))}
    ip = Engine.compile(r"\d+\.\d+\.\d+\.\d+").batch_engine()
    ip._bidi_ascii = True
    s = ip._span_scanner(True).dsd
    cases["events"] = (span_scan._span_full,
                       (s.table, s.cmap, s.starts, s.eoi, s.eoi_kind, dev,
                        tiles, jnp.int32(n)),
                       dict(L=L, T=T, W=W, C=s.C))
    rsc = ip._rev_flag_scanner(True)
    Lr, Tr, Wr = flag_scan.reset_geometry(n)
    syms = flag_scan.reset_symbols(dev, dev == 10, rsc.byte_bounds())
    stiles = tx.make_word_tiles(syms, Lr, Tr // 4)
    cases["flags"] = (flag_scan._flag_full,
                      (rsc.tables.table, stiles, n + 1,
                       jnp.full((Lr,), DEAD, jnp.int32)),
                      dict(L=Lr, T=Tr, W=Wr, NSEG=rsc.tables.NSEG))
    for mode, (fn, args, kw) in cases.items():
        outs = {}
        for impl in ("triton", "xla"):
            t0 = time.perf_counter()
            compiled = fn.lower(*args, impl=impl, **kw).compile()
            t_compile = time.perf_counter() - t0
            _timed(compiled, *args)
            out, t_steady = _timed(compiled, *args)
            outs[impl] = out
            print(f"  {mode:6} {impl:6} compile {t_compile:7.2f} s  steady "
                  f"{t_steady * 1e3:9.3f} ms", flush=True)
            if impl == "triton":
                print(f"  {mode:6} memory_analysis: "
                      f"{compiled.memory_analysis()}", flush=True)
        fails.check(_same(outs["triton"], outs["xla"]),
                    f"kernel {mode}: triton != xla")
    del cases, tiles, stiles, syms
    _release()


def _release():
    import gc
    from coregex_tpu.ops import transducer
    from coregex_tpu.utils import corpus_cache
    corpus_cache.clear()
    transducer._tiles_cache.clear()
    gc.collect()


def _host_searches(eng) -> int:
    return eng.stats.dfa_searches + eng.stats.nfa_searches


def config_phase(name, pattern, base, arr, reps, fails: Failures) -> None:
    import jax
    import jax.numpy as jnp
    import bench
    from coregex_tpu.meta.engine import Engine

    B = len(base)
    t0 = time.perf_counter()
    eng = Engine.compile(pattern)
    eng.batch_threshold = 0
    be = eng.batch_engine()
    t_build = time.perf_counter() - t0
    print(f"{name}: strategy={eng.strategy} build {t_build:.2f} s",
          flush=True)

    # count, full corpus
    m0 = bench.oracle_count(pattern, base)
    c, t_first = _timed(eng.count, arr)
    _, t_steady = _timed(eng.count, arr)
    ok = fails.check(c == reps * m0, f"{name} count {c} != {reps * m0}")
    ok &= fails.check(be.served_by is not None
                      and not be.served_by.startswith("pipeline")
                      and _host_searches(eng) == 0,
                      f"{name} count not served by a device path "
                      f"({be.served_by})")
    print(f"  count      {'ok' if ok else 'FAIL'} n={c} "
          f"[{be.served_by}] first {t_first:.3f} s steady "
          f"{t_steady * 1e3:.2f} ms", flush=True)
    _release()

    # device-resident find_all at bench's slice size
    strat = be.plan.strategy
    fam_limit = (be._spans_limit(strat) if strat.name in be._SPARSE_FAMILIES
                 else min(be._spans_limit(strat), bench.LEGACY_SLICE))
    fa_reps = min(reps, max(1, bench.SPAN_BUDGET // max(m0, 1)),
                  max(1, fam_limit // B))
    fa_arr = arr[:fa_reps * B]
    t0 = time.perf_counter()
    r = be.find_all_spans_device(fa_arr, defer_ok=True)
    ok = fails.check(r is not None,
                     f"{name} find_all: no device path at "
                     f"{len(fa_arr) >> 20} MB")
    if r is not None:
        sd, fcnt, okd = r
        fcnt_h = int(jax.device_get(fcnt))
        rng = np.random.default_rng(123)
        sidx_h = rng.integers(0, max(fcnt_h, 1), 64).astype(np.int32)
        sidx = jax.device_put(jnp.asarray(sidx_h))
        dig = bench.span_digest_device(sd, fcnt, okd, sidx)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd2, fcnt2, okd2 = be.find_all_spans_device(fa_arr, defer_ok=True)
        dig = bench.span_digest_device(sd2, fcnt2, okd2, sidx)
        t_steady = time.perf_counter() - t0
        em, es, ee = bench.oracle_span_digest(pattern, base, fa_reps)
        ok = fails.check(dig[4] == em and dig[0] == es and dig[1] == ee
                         and dig[2], f"{name} find_all digest mismatch")
        if ok and em:
            exp = bench.oracle_sample_spans(pattern, base, sidx_h)
            ok = fails.check(bool((dig[3].astype(np.int64) == exp).all()),
                             f"{name} find_all sampled spans differ")
        print(f"  find_all   {'ok' if ok else 'FAIL'} n={dig[4]} "
              f"slice={len(fa_arr) >> 20} MB [{be.served_by}] first "
              f"{t_first:.3f} s steady {t_steady * 1e3:.2f} ms", flush=True)
        del r, sd, sd2
    _release()

    # public find_all_index on a 64 MB slice vs Python re on that slice
    ix = arr[:max(1, (INDEX_SLICE_MB << 20) // B) * B]
    before = _host_searches(eng)
    got, t_first = _timed(eng.find_all_index, ix)
    path = be.served_by
    exp = [m.span() for m in re.finditer(pattern.encode(), ix.tobytes())]
    ok = fails.check((got or []) == exp,
                     f"{name} find_all_index differs from re "
                     f"({len(got or [])} vs {len(exp)} spans)")
    ok &= fails.check(_host_searches(eng) == before
                      and path is not None and path.startswith("device"),
                      f"{name} find_all_index not served by a device path "
                      f"({path})")
    print(f"  find_all_index {'ok' if ok else 'FAIL'} n={len(exp)} "
          f"[{path}] {t_first:.3f} s", flush=True)
    del got, exp
    _release()

    # is_match / find_index, full corpus
    m = re.search(pattern.encode(), base)
    before = _host_searches(eng)
    im, t_im = _timed(eng.is_match, arr)
    p_im = be.served_by
    fi, t_fi = _timed(eng.find_index, arr)
    p_fi = be.served_by
    ok = fails.check(bool(im) == (m is not None), f"{name} is_match {im}")
    ok &= fails.check(fi == (m.span() if m else None),
                      f"{name} find_index {fi} != {m and m.span()}")
    ok &= fails.check(_host_searches(eng) == before,
                      f"{name} is_match/find_index used the host loop")
    print(f"  is_match   {'ok' if ok else 'FAIL'} {im} [{p_im}] "
          f"{t_im:.3f} s; find_index {fi} [{p_fi}] {t_fi:.3f} s",
          flush=True)
    eng._batch = None
    _release()


def run_one_card(corpus_mb: int = CORPUS_MB, configs=None) -> bool:
    import bench
    from coregex_tpu import native
    fails = Failures()
    print(f"native determinizer: "
          f"{'loaded' if native.get_lib() is not None else 'NOT loaded'}",
          flush=True)
    base = bench.build_base()
    reps = max(1, (corpus_mb << 20) // len(base))
    arr = np.frombuffer(base * reps, dtype=np.uint8)
    print(f"corpus: {len(arr)} bytes ({reps} tiles of {len(base)})",
          flush=True)
    t0 = time.perf_counter()
    kernel_phase(arr, fails)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, pattern, _ref_ms, _src in bench.CONFIGS:
        if configs and name not in configs:
            continue
        try:
            config_phase(name, pattern, base, arr, reps, fails)
        except Exception as ex:  # report and fail, keep the other configs
            fails.check(False, f"{name} raised {type(ex).__name__}: {ex}")
    print(f"total: {time.perf_counter() - t0:.1f} s, "
          f"{len(fails.items)} failures", flush=True)
    return not fails.items


def run_four(corpus_mb: int = CORPUS_MB) -> bool:
    """Engine.count over 4 x corpus_mb sharded on the mesh, against the
    analytic oracle and the one-card count of the same corpus (four
    segments on device 0, the exit state carried)."""
    import jax
    import bench
    from coregex_tpu.dfa.dense import CTX_SOT
    from coregex_tpu.meta.engine import Engine
    fails = Failures()
    ndev = len(jax.devices())
    fails.check(ndev == 4, f"--four needs 4 devices, found {ndev}")
    base = bench.build_base()
    reps = max(1, (corpus_mb << 20) // len(base))
    seg = base * reps
    arr = np.frombuffer(seg * 4, dtype=np.uint8)
    print(f"corpus: {len(arr)} bytes over {ndev} devices", flush=True)
    dev0 = jax.devices()[0]
    segs = [jax.device_put(np.frombuffer(seg, np.uint8), dev0)]
    for name, pattern, _ref_ms, _src in bench.CONFIGS:
        try:
            eng = Engine.compile(pattern)
            eng.batch_threshold = 0
            be = eng.batch_engine()
            exp = 4 * reps * bench.oracle_count(pattern, base)
            c, t_first = _timed(eng.count, arr)
            _, t_shard = _timed(eng.count, arr)
            path = be.served_by
            sc = be._count_scanner_for(arr)

            def one_card():
                total, s = 0, int(sc.cd.starts[CTX_SOT])
                for _ in range(4):  # the same segment, four times
                    cnt, s, conv = jax.device_get(
                        sc.count_from(segs[0], s))
                    assert bool(conv), "one-card repair did not converge"
                    total, s = total + int(cnt), int(s)
                return total + int(sc.cd.eoi_commits[s, CTX_SOT])

            c1, _ = _timed(one_card)
            c1, t_one = _timed(one_card)
            ok = fails.check(c == exp == c1,
                             f"{name}: sharded {c}, one card {c1}, "
                             f"oracle {exp}")
            ok &= fails.check(path == "count_transducer_sharded",
                              f"{name}: served by {path}")
            print(f"{name:16} {'ok' if ok else 'FAIL'} n={c} [{path}] "
                  f"first {t_first:.3f} s  sharded {t_shard * 1e3:.2f} ms"
                  f"  one card {t_one * 1e3:.2f} ms", flush=True)
        except Exception as ex:
            fails.check(False, f"{name} raised {type(ex).__name__}: {ex}")
    return not fails.items


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="sharded count over four cards only")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "coregex_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    require_gpu(jax.devices())
    from coregex_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(card_info(), flush=True)  # nvidia-smi's name, power.limit
    d0 = jax.devices()[0]
    print(f"jax {jax.__version__}: {len(jax.devices())} x {d0.device_kind}",
          flush=True)
    ok = run_four() if args.four else run_one_card()
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
