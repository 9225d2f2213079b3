"""McICA stochastic cloud subcolumn generator.

Re-derivation of /root/reference/GEOS_RadiationShared/cloud_subcol_gen.F90:
exponential (generalized) overlap in cloud presence and condensate
(Raisanen 2004), decorrelation lengths from the Oreopoulos et al. (2012)
latitude/season fit (:51-74, :491-516), condensate-inhomogeneity scaling via
the beta/gamma xcw tables (cloud_condensate_inhomogeneity.F90:86-124), and
per-gridcolumn deterministic seeding from the fractional part of near-surface
layer pressures (:336-400).

Differences from the reference (sanctioned by the reference's own
contract that POPULATION statistics are what matter, cloud_subcol_gen.F90:24-31):
* RNG is JAX's counter-based threefry instead of serial KISS; seeds still
  derive from the model state (fractional surface pressures + seed_order),
  so runs are bit-reproducible and decomposition-invariant.
* The vertical correlation chain "cdf1(l) = cdf1(l-1) if cdf2(l) < alpha(l)"
  is evaluated without a serial scan: each layer's effective random number is
  a GATHER from the nearest uncorrelated "anchor" layer above, computed with
  a cumulative max over layer indices.

Vertical ordering: inputs are TOA-at-index-0 (GEOS convention).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..tables import load

# Oreopoulos et al. (2012) decorrelation-length parameters
# (cloud_subcol_gen.F90:51-74)
AAM1, AAM2, AAM30, AAM4 = 1.4315, 2.1219, 7.0, -25.584      # cloud presence
RAM1, RAM2, RAM30, RAM4 = 0.72192, 0.78996, 8.5, 40.404     # condensate

_R2D = 180.0 / 3.14159265358979323846


def correlation_length(am1, am2, am30, am4, doy, alat):
    """Decorrelation length [m] (cloud_subcol_gen.F90:634-660)."""
    am3 = jnp.where(doy > 181,
                    -4.0 * am30 / 365.0 * (doy - 272),
                    4.0 * am30 / 365.0 * (doy - 91))
    return (am1 + am2 * jnp.exp(-(alat * _R2D - am3) ** 2 / am4 ** 2)) * 1.0e3


def state_seed_ints(play_hpa, seed_order=(0, 1, 2, 3)):
    """Four deterministic uint32 seeds from near-surface layer pressures.

    play_hpa: [nlay] layer pressures, TOA first. Uses the fractional Pa
    of the lowest four layers (cloud_subcol_gen.F90:336-400), permuted by
    seed_order, so the threefry streams derive from the model state.
    """
    pseed = play_hpa[-1:-5:-1] * 100.0      # lowest four layers, in Pa
    pseed = pseed[jnp.asarray(seed_order)]
    maximo = 2147483646.0
    return ((pseed - jnp.floor(pseed)) * maximo + 1.0).astype(jnp.uint32)


def state_seed_key(play_hpa, seed_order=(0, 1, 2, 3)):
    """Deterministic per-column threefry key from the state seeds."""
    ints = state_seed_ints(play_hpa, seed_order)
    key = jax.random.key(0)
    for i in range(4):
        key = jax.random.fold_in(key, ints[i])
    return key


def overlap_params(zmid, alat, doy):
    """Per-layer exponential-overlap correlations (alpha for cloud
    presence, rcorr for condensate), [ncol, nlay] with layer 0 = 0."""
    adl = correlation_length(AAM1, AAM2, AAM30, AAM4, doy, alat)
    rdl = correlation_length(RAM1, RAM2, RAM30, RAM4, doy, alat)
    dz = jnp.abs(zmid[:, 1:] - zmid[:, :-1])
    alpha = jnp.concatenate(
        [jnp.zeros_like(zmid[:, :1]), jnp.exp(-dz / adl[:, None])], axis=1)
    rcorr = jnp.concatenate(
        [jnp.zeros_like(zmid[:, :1]), jnp.exp(-dz / rdl[:, None])], axis=1)
    return alpha, rcorr


def zcw_lookup(cdf, sigma_qcw, inhm):
    """Condensate scaling factor by bilinear lookup in the xcw tables.

    cloud_condensate_inhomogeneity.F90:86-124. inhm: 0 none, 1 beta, 2 gamma
    (static).
    """
    if inhm == 0:
        return jnp.ones_like(cdf)
    tab = load("chou_xcw_inhomogeneity")
    xcw = jnp.asarray(tab["xcw_beta" if inhm == 1 else "xcw_gamma"],
                      cdf.dtype)
    n1, n2 = xcw.shape                       # (1000, 140)
    rind1 = cdf * (n1 - 1) + 1.0
    ind1 = jnp.clip(jnp.floor(rind1).astype(jnp.int32), 1, n1 - 1)
    f1 = rind1 - ind1.astype(cdf.dtype)
    rind2 = 40.0 * sigma_qcw - 3.0
    ind2 = jnp.clip(jnp.floor(rind2).astype(jnp.int32), 1, n2 - 1)
    f2 = rind2 - ind2.astype(cdf.dtype)
    i, j = ind1 - 1, ind2 - 1
    return ((1 - f1) * (1 - f2) * xcw[i, j]
            + (1 - f1) * f2 * xcw[i, j + 1]
            + f1 * (1 - f2) * xcw[i + 1, j]
            + f1 * f2 * xcw[i + 1, j + 1])


def _correlate(cdf, keepmask):
    """Apply the overlap chain: layer l inherits the random number of the
    nearest layer above with keepmask=True (layer 0 always keeps its own).

    cdf, keepmask: [..., nsub, nlay]. Returns correlated cdf.

    Formulated as an associative forward-fill scan over (value, filled)
    pairs — log2(nlay) vectorized selects — instead of the equivalent
    anchor-index + take_along_axis form, which needs a [.., nsub, nlay]
    elementwise gather.
    """
    keep = keepmask.at[..., 0].set(True)

    def combine(a, b):
        va, ka = a
        vb, kb = b
        return jnp.where(kb, vb, va), ka | kb

    filled, _ = lax.associative_scan(combine, (cdf, keep), axis=-1)
    return filled


def _sigma_class(cldfrac):
    """Static sigma_qcw class: 0 -> 0.5 (cf>0.99), 1 -> 0.71 (cf>0.9),
    2 -> 1.0 (cloud_subcol_gen.F90 condensate sigma thresholds)."""
    return ((cldfrac <= 0.99).astype(jnp.int32)
            + (cldfrac <= 0.9).astype(jnp.int32))


@lru_cache(maxsize=None)
def _zcw_class_table(inhm):
    """Two-level lookup table for the 3 sigma_qcw classes {0.5, 0.71, 1.0}.

    Returns a (96, 64) float32 array T2 where, for combined index
    j = class*1024 + (ind1-1) decomposed as j = 32a + b:
    T2[a, 2b]   = xcw column value at ind1   (bilinear in sigma already)
    T2[a, 2b+1] = xcw column value at ind1+1
    """
    tab = np.asarray(load("chou_xcw_inhomogeneity")[
        "xcw_beta" if inhm == 1 else "xcw_gamma"], np.float64)
    n1, n2 = tab.shape                      # (1000, 140)
    cols = []
    for s in (0.5, 0.71, 1.0):
        r2 = 40.0 * s - 3.0
        j = int(min(max(int(r2), 1), n2 - 1))
        f2 = r2 - j
        cols.append((1.0 - f2) * tab[:, j - 1] + f2 * tab[:, j])
    c = np.stack(cols, 0).astype(np.float32)            # (3, 1000)
    lo = np.zeros((3, 1024), np.float32)
    hi = np.zeros((3, 1024), np.float32)
    lo[:, :n1] = c
    hi[:, :n1 - 1] = c[:, 1:]
    t2 = np.zeros((96, 32, 2), np.float32)
    t2[..., 0] = lo.reshape(96, 32)
    t2[..., 1] = hi.reshape(96, 32)
    return t2.reshape(96, 64)


def zcw_lookup_class(cdf, sigcls, inhm):
    """Condensate scaling factor for the 3 static sigma_qcw classes.

    Same numerics as zcw_lookup but with the elementwise table gather
    replaced by a two-level one-hot contraction: a [.., 96] one-hot
    matmul (precision HIGHEST, so exact) fetches a 32-entry sub-block (as
    interleaved lo/hi pairs), and a 32-wide masked sum selects within it.

    cdf: [...] uniform samples; sigcls: [...] int32 in {0,1,2}
    (see _sigma_class); inhm static.
    """
    if inhm == 0:
        return jnp.ones_like(cdf)
    t2 = jnp.asarray(_zcw_class_table(inhm))
    n1 = 1000
    rind1 = cdf * (n1 - 1) + 1.0
    ind1 = jnp.clip(jnp.floor(rind1).astype(jnp.int32), 1, n1 - 1)
    f1 = rind1 - ind1.astype(cdf.dtype)
    j = sigcls * 1024 + (ind1 - 1)
    a = j >> 5
    b = j & 31
    ahot = (a[..., None] == jnp.arange(96, dtype=jnp.int32)).astype(cdf.dtype)
    u = lax.dot_general(ahot, t2, (((ahot.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32,
                        precision=lax.Precision.HIGHEST)
    u = u.reshape(u.shape[:-1] + (32, 2)).astype(cdf.dtype)
    bhot = (b[..., None] == jnp.arange(32, dtype=jnp.int32)).astype(cdf.dtype)
    val = u[..., 0] * (1.0 - f1)[..., None] + u[..., 1] * f1[..., None]
    return jnp.sum(bhot * val, axis=-1)


@partial(jax.jit, static_argnames=("nsubcol", "inhm", "seed_order",
                                   "col_block"))
def generate_stochastic_clouds(zmid, alat, doy, play, cldfrac, ciwp, clwp,
                               cwp_tiny, *, nsubcol, inhm=1,
                               seed_order=(0, 1, 2, 3), col_block=512):
    """Generate McICA subcolumns for a batch of gridcolumns.

    Args:
      zmid: [ncol, nlay] layer mid heights (m), TOA first
      alat: [ncol] latitude (radians)
      doy:  scalar day of year
      play: [ncol, nlay] layer pressure (hPa)
      cldfrac: [ncol, nlay] cloud fraction
      ciwp/clwp: [ncol, nlay] in-cloud ice/liquid water paths
      cwp_tiny: threshold below which water paths reset to zero
      nsubcol: static number of subcolumns (g-points)
      inhm: 0 homogeneous, 1 beta, 2 gamma condensate PDF (static)
      seed_order: static permutation of (0,1,2,3) decorrelating e.g. SW vs LW

    Returns:
      cldy: [ncol, nsubcol, nlay] bool
      ciwp_stoch, clwp_stoch: [ncol, nsubcol, nlay]
    """
    dtype = play.dtype
    doy = jnp.asarray(doy)
    alpha, rcorr = overlap_params(zmid, alat, doy)
    sigcls = _sigma_class(cldfrac)

    def column(play_c, cldf_c, ciwp_c, clwp_c, alpha_c, rcorr_c, sig_c):
        key = state_seed_key(play_c, seed_order)
        nlay = play_c.shape[0]
        shape = (nsubcol, nlay)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        cdf1 = jax.random.uniform(k1, shape, dtype)
        cdf2 = jax.random.uniform(k2, shape, dtype)
        cdf1 = _correlate(cdf1, cdf2 >= alpha_c[None, :])
        cloudy = cdf1 >= 1.0 - cldf_c[None, :]

        if inhm != 0:
            cdf2b = jax.random.uniform(k3, shape, dtype)
            cdf3 = jax.random.uniform(k4, shape, dtype)
            cdf3 = _correlate(cdf3, cdf2b >= rcorr_c[None, :])
            zcw = zcw_lookup_class(cdf3, sig_c[None, :], inhm)
        else:
            zcw = jnp.ones(shape, dtype)

        ciwp_s = jnp.where(cloudy, ciwp_c[None, :] * zcw, 0.0)
        clwp_s = jnp.where(cloudy, clwp_c[None, :] * zcw, 0.0)
        ciwp_s = jnp.where(ciwp_s <= cwp_tiny, 0.0, ciwp_s)
        clwp_s = jnp.where(clwp_s <= cwp_tiny, 0.0, clwp_s)
        cloudy = cloudy & ((ciwp_s > 0.0) | (clwp_s > 0.0))
        return cloudy, ciwp_s, clwp_s

    args = (play, cldfrac, ciwp, clwp, alpha, rcorr, sigcls)
    ncol = play.shape[0]
    if col_block is None or ncol <= col_block or ncol % col_block != 0:
        return jax.vmap(column)(*args)
    # Chunk columns through lax.map so the zcw one-hot intermediates
    # ([block, nsubcol, nlay, 64] and friends) stay bounded in HBM; at
    # ncol=8192/nsubcol=140 the unchunked form needs >21 GB.
    blocked = jax.tree_util.tree_map(
        lambda x: x.reshape((ncol // col_block, col_block) + x.shape[1:]),
        args)
    out = lax.map(lambda a: jax.vmap(column)(*a), blocked)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((ncol,) + x.shape[2:]), out)


def clear_counts_three_band(cldy, cloud_mh, cloud_lm):
    """Counts of fully clear subcolumns: total, high, mid, low bands.

    cldy: [ncol, nsubcol, nlay] TOA-first. cloud_mh/cloud_lm: static layer
    indices (1-based, GEOS LCLDMH/LCLDLM). Mirrors
    cloud_subcol_gen.F90:611-769 (TOA-at-1 branch).

    Returns [ncol, 4] int32 counts (whole, high, mid, low).
    """
    any_tot = jnp.any(cldy, axis=-1)
    any_high = jnp.any(cldy[..., :cloud_mh - 1], axis=-1)
    any_mid = jnp.any(cldy[..., cloud_mh - 1:cloud_lm - 1], axis=-1)
    any_low = jnp.any(cldy[..., cloud_lm - 1:], axis=-1)
    counts = [jnp.sum(~a, axis=-1).astype(jnp.int32)
              for a in (any_tot, any_high, any_mid, any_low)]
    return jnp.stack(counts, axis=-1)
