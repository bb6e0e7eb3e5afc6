"""Large static tensors as jit ARGUMENTS instead of inline constants.

The intra mode-weight tensors (ops/intra.py mode_weights_np: up to
(35, 1024, 258) int32 = 37 MB at N=32) and the per-plan ref-gather
index maps (encoder/geometry.py PlaneMaps.gather_idx flattened to
(N_blocks, 4S+1)) used to be materialized with jnp.asarray inside the
traced search/recon programs.  Each became a dense inline constant in
the StableHLO — ~130 MB of constants per variable-tree program — which
made the programs ~100 MB serialized, slowed compiles and
persistent-cache loads, and bloated device memory with per-program
copies.

Mechanism: code deep inside a traced function calls fetch(key,
builder).  If the enclosing jit entry point bound that key to one of
its arguments (a tracer) via bound(...), the tracer is returned and
the tensor rides in as a runtime argument — device-resident, uploaded
once per process by DevConstPool.  Otherwise the builder materializes
it inline exactly as before (CPU oracle/decoder paths, tests, and any
site not yet threaded keep working unchanged).

Thread-local context: the pipelined encoder traces from worker
threads.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np

_tls = threading.local()


def _ctx() -> dict:
    d = getattr(_tls, "d", None)
    if d is None:
        d = {}
        _tls.d = d
    return d


def fetch(key: str, build):
    """Return the bound tracer/array for key, else materialize inline.

    build: ndarray or zero-arg callable returning one."""
    v = _ctx().get(key)
    if v is not None:
        return v
    import jax.numpy as jnp
    return jnp.asarray(build() if callable(build) else build)


@contextlib.contextmanager
def bound(mapping: dict):
    """Bind {key: array-or-tracer} for the dynamic extent of a traced
    function body (use as the first statement inside the jit entry
    point, passing the jit's own argument pytree)."""
    d = _ctx()
    old = {k: d[k] for k in mapping if k in d}
    d.update(mapping)
    try:
        yield
    finally:
        for k in mapping:
            d.pop(k, None)
        d.update(old)


class DevConstPool:
    """Host-side pool: key -> committed device array, built once per
    process (shared across encoder instances)."""

    def __init__(self):
        self._arrs = {}
        self._lock = threading.Lock()

    def get(self, key: str, build):
        a = self._arrs.get(key)
        if a is None:
            import jax
            with self._lock:
                a = self._arrs.get(key)
                if a is None:
                    a = jax.device_put(np.asarray(
                        build() if callable(build) else build))
                    self._arrs[key] = a
        return a


POOL = DevConstPool()
