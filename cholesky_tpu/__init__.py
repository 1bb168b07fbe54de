"""cholesky_tpu — a sparse SPD direct solver for accelerators (JAX/XLA).

Built from scratch with the capabilities of the Regent/Legion reference solver
(syamajala/cholesky): nested-dissection sparse Cholesky factorization
A = L L^T plus triangular solve, driven by precomputed separator orderings and
cluster hierarchies, verified against SciPy golden models.

Layers (a batched re-design of the reference's five layers, SURVEY.md §1):
  io/        MatrixMarket + ord/clust parsing (C++ fast path in native/)
  symbolic/  separator tree, permutation, panel layout, fill analysis -> SolvePlan
  numeric/   batched multifrontal factor/solve in JAX
  parallel/  jax.sharding mesh distribution of elimination subtrees
  native/    C/C++ host runtime (parsers, ingest, planning core)
"""

__version__ = "0.1.0"


def setup_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.
    JAX_COMPILATION_CACHE_DIR, when set, is used as it is (JAX reads it
    itself) and no other path is set here. Otherwise the cache lives at the
    fixed <checkout>/.jax_cache, or under the temp directory when the
    checkout is not writable (e.g. installed site-packages). Large frontal
    programs take minutes to compile, so a warm cache matters."""
    import os
    import tempfile

    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cache = os.path.join(root, ".jax_cache")
        try:
            os.makedirs(cache, exist_ok=True)
            probe = os.path.join(cache, ".probe")
            with open(probe, "w") as f:
                f.write("")
            os.remove(probe)
        except OSError:
            cache = os.path.join(tempfile.gettempdir(),
                                 "cholesky_tpu_jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache


def force_cpu(n_devices: int = 0) -> None:
    """Pin JAX to the host CPU (optionally with n virtual devices for
    sharding tests) through jax.config, which holds whatever the
    environment says. Call it BEFORE any jax operation: once a backend is
    up the platform choice is frozen, so a late call could not take effect
    and raises instead."""
    import jax

    try:
        from jax._src import xla_bridge

        if xla_bridge.backends_are_initialized():
            if jax.default_backend() == "cpu" and not n_devices:
                return                      # already where we want to be
            raise RuntimeError(
                "force_cpu() called after a JAX backend initialized on "
                f"'{jax.default_backend()}' — the platform choice is "
                "frozen at first use. Call force_cpu() before any other "
                "jax operation.")
    except ImportError:                     # private API moved: best effort
        pass
    jax.config.update("jax_platforms", "cpu")
    if n_devices:
        jax.config.update("jax_num_cpu_devices", n_devices)


def enable_x64() -> None:
    """Enable float64 (the f64 factor path and the host-side residual
    bookkeeping of the 1e-10 contract). Call before any jax array is
    created."""
    import jax

    jax.config.update("jax_enable_x64", True)


from cholesky_tpu.api import (  # noqa: E402,F401
    BatchedFactors, SparseCholesky, solve_spd, spsolve)
