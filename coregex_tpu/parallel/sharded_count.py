"""Multi-device exact Go count: the one-card count transducer per shard.

The count transducer (dfa/countdfa.py) turns the whole FindAll restart
loop into one weighted DFA, so the exact Go match count distributes the
way the lanes inside one card already do (ops/transducer.py), one level
up:

  guess  — each device holds one contiguous shard; its entry state is
           guessed by scanning a W-byte halo (the previous shard's tail,
           passed with one `ppermute`) from a context start state;
  scan   — each device counts its shard with the one-card transducer
           (count_scan.count_lanes), giving (count, exit state);
  repair — (entry, count, exit) all-gather; a shard whose guessed entry
           differs from the previous shard's exit rescans from that
           exit, until the chain holds (at most one round per shard,
           usually none).  The per-shard counts sum on the host.

This is the sequence-parallel path Engine.count takes when more than
one device is visible (SURVEY.md §2.9).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dfa.dense import CTX_SOT
from ..ops import transducer as tx
from ..ops.count_scan import _byte_ctx, count_lanes


class ShardedGoCount:
    """Per-(count scanner, mesh) sharded counter; one compiled program
    per shard-length bucket."""

    def __init__(self, sc, mesh: Mesh, axis: str = "data"):
        self.sc = sc
        self.cd = sc.cd
        self.mesh = mesh
        self.axis = axis
        self.ndev = int(mesh.shape[axis])
        self._fns = {}
        self._corpus = None  # (fingerprint, SL, sharded device array)

    def _build(self, SL: int):
        d = self.sc.dcd
        impl = self.sc.impl
        axis, ndev = self.axis, self.ndev
        L, T, W = tx.plan_geometry(SL)
        C = d.C
        sot = jnp.int32(self.cd.starts[CTX_SOT])

        def halo_guess(starts_tbl, table, cmap, halo):
            """Entry guess at the shard start: the start state for the
            context of the halo's first byte, stepped over the rest."""
            ctx = _byte_ctx(halo[0].astype(jnp.int32))
            s0 = starts_tbl[ctx]

            def step(s, b):
                return table[s * C + cmap[b]] >> 5, None

            s, _ = jax.lax.scan(step, s0, halo[1:].astype(jnp.int32))
            return s

        def body(shard, n_shard, table, cmap, starts_tbl):
            my = jax.lax.axis_index(axis)
            n_my = n_shard[0]
            halo = jax.lax.ppermute(
                shard[SL - W:], axis,
                perm=[(i, i + 1) for i in range(ndev - 1)])
            entry = jnp.where(my == 0, sot,
                              halo_guess(starts_tbl, table, cmap, halo))
            tiles = tx.make_word_tiles(shard, L, T // 4)

            def scan_from(first):
                return count_lanes(table, cmap, starts_tbl, shard, tiles,
                                   n_my, first, L, T, W, C, impl)

            cnt, ext, conv = scan_from(entry)

            def gather(*xs):
                return [jax.lax.all_gather(x, axis) for x in xs]

            ents, cnts, exts, convs = gather(entry, cnt, ext, conv)
            real = jax.lax.all_gather(n_my, axis) > 0

            def bad(ents, exts):
                want = jnp.concatenate([sot[None], exts[:-1]])
                return real & (ents != want), want

            def cond(st):
                k, ents, cnts, exts, convs = st
                return (k < ndev) & jnp.any(bad(ents, exts)[0])

            def rep(st):
                k, ents, cnts, exts, convs = st
                mism, want = bad(ents, exts)
                mine = mism[my]
                first = jnp.where(mine, want[my], ents[my])
                c2, e2, v2 = jax.lax.cond(
                    mine, scan_from,
                    lambda f: (cnts[my], exts[my], convs[my]), first)
                return (k + 1, *gather(first, c2, e2, v2))

            _, ents, cnts, exts, convs = jax.lax.while_loop(
                cond, rep, (jnp.int32(0), ents, cnts, exts, convs))
            ok = jnp.all(convs) & ~jnp.any(bad(ents, exts)[0])
            return cnts, exts, ok

        smapped = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(), P(), P()),
            out_specs=(P(), P(), P()), check_vma=False)
        return jax.jit(smapped)

    def _put(self, data: np.ndarray, SL: int):
        """Host corpus -> [ndev * SL] array with shard d on device d
        (only the last real shard is padded, on the host).  The last
        corpus stays cached, keyed like utils/corpus_cache.device_corpus
        (length + sampled fingerprint), so repeat counts skip the
        upload."""
        from ..utils.corpus_cache import _fingerprint
        fp = _fingerprint(data)
        if self._corpus is not None and self._corpus[:2] == (fp, SL):
            return self._corpus[2]
        self._corpus = None
        n = len(data)

        def shard_of(idx):
            s = idx[0].start or 0
            part = data[s:min(n, s + SL)]
            if len(part) < SL:
                part = np.concatenate(
                    [part, np.zeros(SL - len(part), np.uint8)])
            return part

        sharding = NamedSharding(self.mesh, P(self.axis))
        arr = jax.make_array_from_callback((self.ndev * SL,), sharding,
                                           shard_of)
        self._corpus = (fp, SL, arr)
        return arr

    def count(self, data: np.ndarray):
        """Exact Go match count of `data` (host uint8 array), or None
        when lane or shard repair did not converge."""
        n = len(data)
        cd = self.cd
        sot = int(cd.starts[CTX_SOT])
        if n == 0:
            return int(cd.eoi_commits[sot, CTX_SOT])
        SL = tx.size_bucket(-(-n // self.ndev))
        SL = -(-SL // 64) * 64
        fn = self._fns.get(SL)
        if fn is None:
            fn = self._fns[SL] = self._build(SL)
        n_shard = np.clip(n - np.arange(self.ndev, dtype=np.int64) * SL,
                          0, SL).astype(np.int32)
        d = self.sc.dcd
        cnts, exts, ok = jax.device_get(fn(
            self._put(data, SL),
            jax.device_put(n_shard, NamedSharding(self.mesh, P(self.axis))),
            d.table, d.cmap, d.starts))
        if not bool(ok):
            return None
        last = int(np.flatnonzero(n_shard > 0)[-1])
        total = int(np.asarray(cnts, dtype=np.int64)[n_shard > 0].sum())
        return total + int(cd.eoi_commits[int(exts[last]), CTX_SOT])
