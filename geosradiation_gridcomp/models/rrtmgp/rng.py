"""Random-number generator hierarchy (mo_rng equivalents).

The reference ships an abstract ty_rng (RRTMGP_cmake/rng/mo_rng.F90:22-31)
with MKL-VSL (Philox) and Mersenne-Twister implementations; the Solar GC
seeds one stream per column from the global grid location
(GEOS_SolarGridComp.F90:5206-5224). Here the default is a
counter-based threefry generator (jax.random) which is the natural
Philox analog - stateless, splittable, reproducible across shardings;
an MT19937 host-side generator is provided for exact-sequence needs in
offline tooling.
"""

import numpy as np

import jax
import jax.numpy as jnp


class ThreefryRNG:
    """Counter-based device RNG (the MKL-VSL Philox analog)."""

    def __init__(self, seeds):
        """seeds: int or int sequence (mixed into one key), e.g. the
        per-column global index like the reference's Philox seeding."""
        seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
        key = jax.random.PRNGKey(int(seeds[0]))
        for s in seeds[1:]:
            key = jax.random.fold_in(key, int(s))
        self._key = key

    def get_random_vec(self, num_or_shape):
        """Uniform (0,1) draws; advances the stream."""
        shape = (num_or_shape,) if isinstance(num_or_shape, int) \
            else tuple(num_or_shape)
        self._key, sub = jax.random.split(self._key)
        return jax.random.uniform(sub, shape, jnp.float32)

    def get_random_vec_mask(self, mask):
        """Draws only for True elements of mask (others zero), matching
        mo_rng's get_random_vec_mask contract."""
        mask = jnp.asarray(mask)
        r = self.get_random_vec(mask.shape)
        return jnp.where(mask, r, 0.0)

    # mo_rng naming
    init_rng = __init__

    def end_rng(self):
        self._key = None


class MT19937RNG:
    """Host-side Mersenne-Twister (mo_rng_mt19937 equivalent)."""

    def __init__(self, seeds):
        seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
        self._rs = np.random.Generator(np.random.MT19937(seeds))

    def get_random_vec(self, num_or_shape):
        shape = (num_or_shape,) if isinstance(num_or_shape, int) \
            else tuple(num_or_shape)
        return self._rs.random(shape, np.float64)

    def get_random_vec_mask(self, mask):
        mask = np.asarray(mask)
        out = np.zeros(mask.shape)
        out[mask] = self._rs.random(int(mask.sum()))
        return out

    def end_rng(self):
        self._rs = None
