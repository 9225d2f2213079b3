"""RRTMG-LW McICA cloud optical depths (cldprmc).

Re-derivation of rrtmg_lw_cldprmc.F90:26-380: per-g-point absorption-only
cloud optical depth from in-cloud ice/liquid water paths and particle sizes.
Ice parameterizations: 0 constant, 1 Ebert-Curry 5-band, 2 Key (Streamer),
3 Fu (1998), 4 (extended table); liquid: Hu & Stamnes (1993).

Layout note: particle sizes vary only per (column, layer), so the
radius interpolation gathers CONTIGUOUS 16-band table rows with
[ncol, nlay] indices, then expands band->g-point with a static index map -
never an elementwise [ncol, ngpt, nlay] dynamic gather.
"""

import jax.numpy as jnp
import numpy as np

from ...tables import load
from .tables_lw import NG_LW

# band -> 5-band index for iceflag==1 (rrlw_cld.F90:21-22)
_ICE1B = np.array([1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5]) - 1
_NGB = np.repeat(np.arange(16), NG_LW)    # g-point -> band (0-based)


def _interp_rows(tab, index, fint):
    """tab (n, nb); index/fint [ncol, nlay] -> [ncol, nlay, nb]: two
    contiguous-row gathers and a linear blend."""
    lo = tab[index - 1]
    hi = tab[index]
    return lo + fint[..., None] * (hi - lo)


def cldprmc_lw(cldymc, ciwpmc, clwpmc, reice, reliq, iceflag=3, liqflag=1):
    """Cloud optical depth per g-point.

    cldymc: [..., ngpt, nlay] bool; ciwpmc/clwpmc same shape (g/m^2);
    reice/reliq: [..., nlay] microns.

    Returns (taucmc [..., ngpt, nlay], cloudy [..., nlay] bool).
    """
    t = load("rrtmg_lw_cld")
    dtype = ciwpmc.dtype

    if iceflag == 0:
        a = t["absice0"]
        absco_g = (float(a[0])
                   + float(a[1]) / jnp.maximum(reice, 1e-6))[..., None, :]
    elif iceflag == 1:
        a = t["absice1"]                          # (2, 5)
        band5 = _ICE1B[_NGB]                      # [ngpt]
        c1 = jnp.asarray(a[0][band5], dtype)[:, None]
        c2 = jnp.asarray(a[1][band5], dtype)[:, None]
        absco_g = c1 + c2 / jnp.maximum(reice[..., None, :], 1e-6)
    else:
        tab = jnp.asarray(t[{2: "absice2", 3: "absice3",
                             4: "absice4"}[iceflag]], dtype)   # (n, 16)
        n = tab.shape[0]
        factor = (reice - 2.0) / 3.0
        index = jnp.clip(jnp.floor(factor).astype(jnp.int32), 1, n - 1)
        fint = factor - index.astype(dtype)
        absco_band = _interp_rows(tab, index, fint)   # [..., nlay, 16]
        absco_g = jnp.swapaxes(absco_band[..., _NGB], -1, -2)  # [...,ngpt,nlay]

    tau_ice = jnp.where(cldymc & (ciwpmc > 0.0), ciwpmc * absco_g, 0.0)

    assert liqflag == 1
    tabl = jnp.asarray(t["absliq1"], dtype)       # (58, 16)
    nl = tabl.shape[0]
    factor = reliq - 1.5
    index = jnp.clip(jnp.floor(factor).astype(jnp.int32), 1, nl - 1)
    fint = factor - index.astype(dtype)
    absliq_band = _interp_rows(tabl, index, fint)
    absliq_g = jnp.swapaxes(absliq_band[..., _NGB], -1, -2)
    tau_liq = jnp.where(cldymc & (clwpmc > 0.0), clwpmc * absliq_g, 0.0)

    taucmc = tau_ice + tau_liq
    cloudy = jnp.any(taucmc > 0.0, axis=-2)
    return taucmc, cloudy
