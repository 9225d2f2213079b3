"""Process-level JAX settings shared by the entry-point scripts."""

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ):
    """(directory, set_here): JAX's persistent compile cache directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the
    program sets nothing (set_here False). Otherwise the cache lives at the
    fixed <checkout>/.jax_cache, so a later process of the same checkout
    finds what an earlier one compiled.
    """
    if environ.get(CACHE_ENV):
        return environ[CACHE_ENV], False
    return os.path.join(CHECKOUT, ".jax_cache"), True


def use_compile_cache():
    """Point JAX's persistent compile cache at compile_cache_dir()."""
    import jax

    path, set_here = compile_cache_dir()
    if set_here:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
