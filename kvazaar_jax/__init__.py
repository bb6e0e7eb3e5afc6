"""kvazaar_jax — an HEVC (H.265) encoder whose compute plane is JAX.

A from-scratch re-design of the capabilities of the Kvazaar HEVC encoder
(reference: 1314wu/kvazaar, analyzed in SURVEY.md) for an accelerator:

- per-CTU compute (intra/inter search, transform, quant, reconstruction,
  in-loop filters) runs as batched JAX/XLA programs over whole
  wavefronts of CTUs at once (reference: per-LCU pthread jobs,
  src/encoderstate.c:612);
- the serial-by-nature CABAC entropy stage runs host-side in C++, fed
  by device-computed syntax-element tensors (reference: src/cabac.c,
  src/encode_coding_tree.c);
- multi-device scaling uses jax.sharding meshes (tiles / CTU-row shards
  within a frame) instead of the reference's pthread threadqueue
  (src/threadqueue.c).
"""

__version__ = "0.1.0"

import os as _os

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir():
    """Directory of the persistent XLA compile cache, or None when off.

    $JAX_COMPILATION_CACHE_DIR wins whenever it is set, and an empty
    value disables the cache (the CPU test suite sets it empty, see
    tests/conftest.py).  Unset, the cache lives at a fixed path inside
    the checkout, so every process of one checkout finds the programs
    an earlier one compiled."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env is not None:
        return env or None
    return _os.path.join(_CHECKOUT, ".jax_cache")


def serialize_jax_compiles() -> None:
    """Serialize XLA compile + persistent-cache access with a process
    lock.  The encoder's pipelined paths compile from worker threads;
    concurrent cache reads have crashed the interpreter inside the
    zstd/deserialize path (segfault in
    compilation_cache.get_executable_and_time)."""
    import threading

    import jax._src.compiler as _compiler
    if getattr(_compiler, "_kvz_serialized", False):
        return
    lock = threading.Lock()
    orig = _compiler.compile_or_get_cached

    def locked(*a, **kw):
        with lock:
            return orig(*a, **kw)

    _compiler.compile_or_get_cached = locked
    _compiler._kvz_serialized = True


def enable_compile_cache() -> None:
    """Point JAX's persistent compile cache at compile_cache_dir().
    Programs that compile in under JAX's threshold (1 s) are not cached:
    they are cheap to rebuild, and thousands of small entries would
    crowd the large search and recon programs out of a bounded cache."""
    import jax
    cache_dir = compile_cache_dir()
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    serialize_jax_compiles()


from kvazaar_jax.config import Config  # noqa: E402,F401
