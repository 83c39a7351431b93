"""FlagResetScanner: flag-word emission vs the round-4 ResetScanner,
through the plain XLA scan and the Triton kernel (interpret mode)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from coregex_tpu.meta.engine import Engine
from coregex_tpu.ops.flag_scan import FlagResetScanner
from coregex_tpu.ops.dfa_scan import ResetScanner
from coregex_tpu.dfa.dense import CTX_OTHER, CTX_WORD


def _mk(pattern, corpus, rmask_positions, rctx):
    eng = Engine.compile(pattern)
    be = eng.batch_engine()
    dd = be._dense("fwd_suffix")
    dev = jnp.asarray(np.frombuffer(corpus, dtype=np.uint8))
    n = len(corpus)
    rmask = np.zeros(n, dtype=bool)
    rmask[[p for p in rmask_positions if p < n]] = True
    return be, dd, dev, jnp.asarray(rmask), n


def _expected_words(be, dd, dev, rmask, n):
    sc = ResetScanner(dd)
    flags, exits, conv, interf, (L, T) = sc.scan_device(dev, rmask)
    flag, eoi = be._flags_with_eoi(flags, n, True)
    f1 = np.concatenate([np.asarray(jax.device_get(flag)),
                         [bool(jax.device_get(eoi))]])
    nw = -(-(n + 1) // 32)
    fp = np.pad(f1, (0, nw * 32 - (n + 1)))
    words = np.zeros(nw, dtype=np.int64)
    for j in range(32):
        words |= fp[j::32].astype(np.int64) << j
    return words.astype(np.uint32).astype(np.int64), conv, interf


CASES = [
    # (pattern whose fwd_suffix DFA verifies the suffix after the lit,
    #  corpus, reset positions right after '@' occurrences)
    (r"[\w.+-]+@[\w.-]+\.[\w.-]+",
     b"aa u@x.com bb c@d.org x@@ e@f and tail@end.io",
     None, CTX_OTHER),
    (r"\w+://[^\s]+",
     b"see http://a.b and ftp://x zz:// end https://q.r/s?t=1",
     None, CTX_OTHER),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_flag_scan_matches_reset_scanner(case, impl, request):
    if impl == "triton":
        request.getfixturevalue("triton_interpret")
    pattern, corpus, _, rctx = case
    # resets right after each lit occurrence (the INNER rmask shape)
    eng = Engine.compile(pattern)
    be = eng.batch_engine()
    lit = bytes(be.plan.split.lit)
    k = len(lit)
    pos = []
    i = corpus.find(lit)
    while i >= 0:
        if i + k < len(corpus):
            pos.append(i + k)
        i = corpus.find(lit, i + 1)
    be, dd, dev, rmask, n = _mk(pattern, corpus, pos, rctx)
    exp_words, conv_e, interf_e = _expected_words(be, dd, dev, rmask, n)
    fsc = FlagResetScanner(dd, rctx, impl=impl)
    fw, interf, conv, _h = fsc.scan_words(dev, rmask)
    fw = np.asarray(jax.device_get(fw)).astype(np.uint32).astype(
        np.int64)
    assert bool(jax.device_get(conv))
    nw = len(exp_words)
    assert (fw[:nw] == exp_words).all(), (
        np.flatnonzero(fw[:nw] != exp_words), fw[:nw], exp_words)
    assert (fw[nw:] == 0).all()
    got_interf = int(jax.device_get(interf))
    assert (got_interf > 0) == bool(jax.device_get(interf_e))


def test_flag_scan_interference_detected():
    # overlapping candidate runs: a reset landing on a live state
    pattern = r"[\w.+-]+@[\w.-]+\.[\w.-]+"
    corpus = b"x@a.b@c.d y@e.fg end"
    eng = Engine.compile(pattern)
    be = eng.batch_engine()
    dd = be._dense("fwd_suffix")
    n = len(corpus)
    pos = [i + 1 for i in range(n) if corpus[i:i + 1] == b"@"
           and i + 1 < n]
    dev = jnp.asarray(np.frombuffer(corpus, dtype=np.uint8))
    rmask = np.zeros(n, dtype=bool)
    rmask[pos] = True
    fsc = FlagResetScanner(dd, CTX_OTHER, impl="xla")
    fw, interf, conv, _h = fsc.scan_words(dev, jnp.asarray(rmask))
    sc = ResetScanner(dd)
    _, _, _, interf_e, _ = sc.scan_device(dev, jnp.asarray(rmask))
    assert (int(jax.device_get(interf)) > 0) == bool(
        jax.device_get(interf_e))
