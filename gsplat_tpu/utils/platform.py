"""Platform rules shared by the renderer and its scripts: which compositing
backend ``"auto"`` means on this platform, and where the persistent compile
cache lives."""

from __future__ import annotations

import os

import jax

# Platform → the compositing backend ``backend="auto"`` resolves to.
AUTO_BACKEND = {"gpu": "pallas", "cpu": "tiles"}


def resolve_backend(backend: str = "auto") -> str:
    """``"auto"`` → the fused Pallas kernel on a GPU, the pure-XLA ``tiles``
    compositor on the CPU; any other platform is an error.  Explicit names
    pass through unchanged (``"pallas_interpret"`` is the test backend: the
    same kernel through the Pallas interpreter, never picked by ``auto``)."""
    if backend != "auto":
        return backend
    platform = jax.devices()[0].platform
    if platform not in AUTO_BACKEND:
        raise RuntimeError(
            f"no compositing backend for platform {platform!r}: supported "
            f"platforms are {sorted(AUTO_BACKEND)}"
        )
    return AUTO_BACKEND[platform]


def setup_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    is set here.  Otherwise the cache goes to ``<root>/.jax_cache`` — a fixed
    path, because the path is part of what a later run must find again.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
