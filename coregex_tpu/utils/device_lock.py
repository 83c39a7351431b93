"""Per-device dispatch serialization.

One chip executes one kernel at a time, so concurrent device dispatch
gains nothing — and concurrent XLA computations (a shard_map collective
racing a span assembly) have crashed this runtime under thread stress.
Every device entry point serializes on the lock FOR ITS BACKEND; host
paths (PikeVM, backtracker) stay concurrent, and programs driving two
distinct jax backends (e.g. a GPU client plus a CPU client) get one
lock each rather than a module-global bottleneck.  The reference is
embarrassingly concurrent by design (meta/engine.go:126-156); this is
the device-runtime-safety analogue, scoped as narrowly as the observed
failure allows.

Reentrant because pipelines call each other (find_all -> find_first).
"""

from __future__ import annotations

import threading

_REGISTRY: dict = {}
_REGISTRY_GUARD = threading.Lock()


def device_lock(backend: str | None = None) -> threading.RLock:
    """The dispatch lock for `backend` (default: jax.default_backend()).

    Lazy: does not import jax (and thus does not initialize a client)
    until first use on the default backend."""
    if backend is None:
        import jax
        backend = jax.default_backend()
    with _REGISTRY_GUARD:
        lk = _REGISTRY.get(backend)
        if lk is None:
            lk = _REGISTRY[backend] = threading.RLock()
        return lk
