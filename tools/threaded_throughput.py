"""Threaded device throughput (round-4 verdict weak item 4 follow-up).

The per-backend device-dispatch lock (utils/device_lock.py) serializes
kernel launches; one chip runs one kernel at a time, so the question is
how much HOST-side prep overlaps device work when a multi-threaded
server drives independent engines.  This measures aggregate count()
throughput for 1..8 threads, one engine + corpus slice per thread,
repeated enough to amortize the sync floor.

Run on the GPU host: `python tools/threaded_throughput.py`
(env COREGEX_TPU_TT_MB to size the per-thread corpus, default 192).
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bench import build_base
    from coregex_tpu.meta.engine import Engine

    mb = int(os.environ.get("COREGEX_TPU_TT_MB", "192"))
    base = build_base()
    reps = max(1, mb * 1024 * 1024 // len(base))
    corpus = np.frombuffer(base * reps, dtype=np.uint8)
    n = len(corpus)
    patterns = [r"\d+\.\d+\.\d+\.\d+", r"error", r"[\w]+",
                r"\w+://[^\s]+", r"GET|POST|PUT|DELETE",
                r".*\.txt", r"\d+.\d+.\d+", r"error|warning|notice"]

    print(f"per-thread corpus: {n/1e6:.0f} MB", flush=True)
    rows = []
    for nt in (1, 2, 4, 8):
        engines = []
        for t in range(nt):
            e = Engine.compile(patterns[t % len(patterns)])
            e.batch_threshold = 0
            engines.append(e)
        # warm every engine (compiles + caches) outside the clock
        for e in engines:
            e.count(corpus)
        REPS = 3
        t0 = time.perf_counter()
        errs = []

        def worker(e):
            try:
                for _ in range(REPS):
                    e.count(corpus)
            except Exception as ex:  # pragma: no cover
                errs.append(ex)

        threads = [threading.Thread(target=worker, args=(e,))
                   for e in engines]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if errs:
            print(f"threads={nt}: ERROR {errs[0]}", flush=True)
            continue
        agg = nt * REPS * n / dt / 1e9
        rows.append((nt, dt, agg))
        print(f"threads={nt:2d}  wall={dt:6.2f}s  aggregate="
              f"{agg:6.2f} GB/s", flush=True)
    if rows:
        base_gbps = rows[0][2]
        for nt, dt, agg in rows:
            print(f"  {nt} threads: {agg/base_gbps:.2f}x single-thread "
                  "aggregate", flush=True)


if __name__ == "__main__":
    main()
