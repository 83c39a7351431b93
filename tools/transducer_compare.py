"""Time the transducer kernel against the plain XLA scan, end to end.

    python tools/transducer_compare.py [--mb 1536] [--reps 3]

For the bench configs whose count and find_all run through the
transducer (count mode for `count`; event and flag modes for the
bidirectional find_all), builds a fresh engine per implementation and
times `Engine.count` and the device-resident find_all on bench's corpus,
alternating triton, xla, xla, triton so drift shows.  Prints one line
per (config, operation, implementation) with the best time, and the
card's name and power limit.  GPU only.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = ("ip", "version", "email", "url", "inner_keyword")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=1536)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import jax
    import numpy as np
    import bench
    from chip_smoke import card_info, require_gpu
    from coregex_tpu.meta.engine import Engine
    from coregex_tpu.ops import transducer
    from coregex_tpu.utils.compile_cache import enable_compile_cache
    require_gpu(jax.devices())
    enable_compile_cache()
    print(f"card: {card_info()}", flush=True)
    base = bench.build_base()
    reps = max(1, (args.mb << 20) // len(base))
    arr = np.frombuffer(base * reps, dtype=np.uint8)
    pats = {name: pat for name, pat, _r, _s in bench.CONFIGS}

    def best(fn):
        jax.block_until_ready(fn())
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        return min(times)

    for name in CONFIGS:
        for impl in ("triton", "xla", "xla", "triton"):
            transducer.default_impl = lambda impl=impl: impl
            eng = Engine.compile(pats[name])
            eng.batch_threshold = 0
            be = eng.batch_engine()
            t_count = best(lambda: eng.count(arr))
            path = be.served_by
            t_fa = best(lambda: be.find_all_spans_device(arr, defer_ok=True))
            print(f"{name:14} {impl:6} count {t_count * 1e3:9.2f} ms "
                  f"[{path}]  find_all {t_fa * 1e3:9.2f} ms "
                  f"[{be.served_by}]", flush=True)
            eng._batch = None
            bench._release_device_corpora(None)
    print(f"card: {card_info()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
