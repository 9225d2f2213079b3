"""COSP statistics vertical regridding (the 40-level stat grid).

Re-derivation of cosp_stats.F90: COSP_CHANGE_VERTICAL_GRID (:148-264)
maps subcolumn profiles from model layers onto a fixed-height output
grid (the CloudSat 480 m grid when csat_vgrid, CONSTRUCT_COSP_VGRID,
cosp_types.F90:554-605) by overlap-weighted averaging; radar
reflectivities convert through linear Z units (log_units).

Design: the reference's per-point 4-case weight loops collapse to a
single interval-overlap formula w = max(0, min(xu,zu) - max(xl,zl)) and
the weighted mean becomes one einsum over model levels (a matrix
contraction at precision HIGHEST), vectorized over points, columns, and output levels.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

R_UNDEF = -1.0e30


def csat_vgrid_bounds(nlr=40, cloudsat=True):
    """(zl, zu) bounds [m] of the stat grid, ascending from the ground
    (CONSTRUCT_COSP_VGRID: 480 m CloudSat spacing, else uniform to
    20 km)."""
    zstep = 480.0 if cloudsat else 20000.0 / nlr
    zl = np.arange(nlr) * zstep
    return zl, zl + zstep


@partial(jax.jit, static_argnames=("log_units",))
def change_vertical_grid(y, zle, zl, zu, log_units=False):
    """Regrid subcolumn profiles to fixed-height bins.

    Args:
      y:     [np, ncol, nlev] profiles on model layers, TOA-first
             (this package's convention; the reference stores
             bottom-first, the overlap math is order-free)
      zle:   [np, nlev+1] edge heights (m), TOA-first
      zl/zu: [M] output bin bottom/top heights (m), ground-ascending
      log_units: values are dB; average in linear units (10^(y/10))

    Returns [np, ncol, M] on the stat grid (index 0 = lowest bin);
    R_UNDEF where a bin lies entirely below the model bottom or has no
    weight (COSP_CHANGE_VERTICAL_GRID semantics).
    """
    dtype = y.dtype
    zl = jnp.asarray(zl, dtype)
    zu = jnp.asarray(zu, dtype)
    xu = zle[:, :-1]                     # layer tops   [np, nlev]
    xl = zle[:, 1:]                      # layer bottoms
    # interval overlap (the reference's four cases in one expression)
    w = jnp.maximum(
        jnp.minimum(xu[:, :, None], zu[None, None, :])
        - jnp.maximum(xl[:, :, None], zl[None, None, :]), 0.0)
    # [np, nlev, M]
    if log_units:
        yp = jnp.where(y != R_UNDEF, 10.0 ** (y / 10.0), 0.0)
    else:
        yp = y
    ws = jnp.sum(w, axis=1)                                  # [np, M]
    swy = jnp.einsum("pcl,plm->pcm", yp, w, precision="highest")
    r = jnp.where(ws[:, None, :] > 0.0,
                  swy / jnp.maximum(ws, 1e-30)[:, None, :], R_UNDEF)
    # bins entirely below the model bottom level stay undefined
    above = zu[None, :] > zle[:, -1:]                        # [np, M]
    r = jnp.where(above[:, None, :], r, R_UNDEF)
    if log_units:
        r = jnp.where((r > 0.0) & above[:, None, :],
                      10.0 * jnp.log10(jnp.maximum(r, 1e-30)), R_UNDEF)
    return r
