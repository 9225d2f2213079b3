"""RRTMG-SW McICA cloud optics with delta scaling (cldprmc_sw).

Re-derivation of rrtmg_sw_cldprmc.F90:40-330: per-g-point extinction, ssa,
asymmetry from in-cloud water paths and particle sizes; ice options
Ebert-Curry (1), Key/Streamer (2), Fu (3); liquid Hu-Stamnes; delta-scaled
with forward fraction f = g^2 (f from the Fu fdelta table for iceflag 3).

Layout note (same as cldprmc_lw): the radius interpolation gathers
contiguous 14-band table rows with [ncol, nlay] indices, then expands
band->g-point with a static index map; water paths are the only per-g
quantities.
"""

import jax.numpy as jnp
import numpy as np

from ...tables import load
from .tables_sw import NG_SW

_NGB = np.repeat(np.arange(16, 30), NG_SW)     # band 16..29 per g
_BAND_G = _NGB - 16                            # 0-based band per g
_CLDMIN = 1.0e-20


def _interp_rows(tab, index, fint):
    """tab (n, 14); index/fint [..., nlay] -> [..., nlay, 14] (see
    cldprmc_lw._interp_rows)."""
    lo = tab[index - 1]
    hi = tab[index]
    return lo + fint[..., None] * (hi - lo)


def _to_g(band_arr):
    """[..., nlay, 14] -> [..., ngpt, nlay] via the static band map."""
    return jnp.swapaxes(band_arr[..., _BAND_G], -1, -2)


def cldprmc_sw(cldymc, ciwpmc, clwpmc, reice, reliq, iceflag=3, liqflag=1):
    """Returns (taucmc, ssacmc, asmcmc, taormc), each [..., ngpt, nlay].

    cldymc: [..., ngpt, nlay] bool; ciwpmc/clwpmc g/m^2; reice/reliq
    [..., nlay] um.
    """
    t = load("rrtmg_sw_cld")
    dtype = ciwpmc.dtype

    if iceflag == 1:
        icxa = np.asarray(t["icxa"], np.int64)
        ib5 = icxa[_BAND_G] - 1                   # per-g 5-band index
        re_i = reice[..., None, :]
        abari = t["abari"][ib5][:, None]
        bbari = t["bbari"][ib5][:, None]
        cbari = t["cbari"][ib5][:, None]
        dbari = t["dbari"][ib5][:, None]
        ebari = t["ebari"][ib5][:, None]
        fbari = t["fbari"][ib5][:, None]
        extcoice = abari + bbari / jnp.maximum(re_i, 1e-6)
        ssacoice = 1.0 - cbari - dbari * re_i
        gice = jnp.minimum(ebari + fbari * re_i, 1.0 - 1e-6)
        forwice = gice * gice
    else:
        suff = {2: "2", 3: "3"}[iceflag]
        ext = jnp.asarray(t["extice" + suff], dtype)   # (n, 14)
        ssa = jnp.asarray(t["ssaice" + suff], dtype)
        asy = jnp.asarray(t["asyice" + suff], dtype)
        n = ext.shape[0]
        factor = (reice - 2.0) / 3.0
        index = jnp.clip(jnp.floor(factor).astype(jnp.int32), 1, n - 1)
        fint = factor - index.astype(dtype)
        extcoice = _to_g(_interp_rows(ext, index, fint))
        ssacoice = _to_g(_interp_rows(ssa, index, fint))
        gice = _to_g(_interp_rows(asy, index, fint))
        if iceflag == 3:
            fdl = jnp.asarray(t["fdlice3"], dtype)
            fdelta = _to_g(_interp_rows(fdl, index, fint))
            forwice = jnp.minimum(
                fdelta + 0.5 / jnp.maximum(ssacoice, 1e-12), gice)
        else:
            forwice = gice * gice

    has_ice = cldymc & (ciwpmc > 0.0)
    extcoice = jnp.where(has_ice, extcoice, 0.0)
    ssacoice = jnp.where(has_ice, ssacoice, 0.0)
    gice = jnp.where(has_ice, gice, 0.0)
    forwice = jnp.where(has_ice, forwice, 0.0)

    assert liqflag == 1
    extl = jnp.asarray(t["extliq1"], dtype)       # (58, 14)
    ssal = jnp.asarray(t["ssaliq1"], dtype)
    asyl = jnp.asarray(t["asyliq1"], dtype)
    nl = extl.shape[0]
    factor_l = reliq - 1.5
    index_l = jnp.clip(jnp.floor(factor_l).astype(jnp.int32), 1, nl - 1)
    fint_l = factor_l - index_l.astype(dtype)
    extcoliq = _to_g(_interp_rows(extl, index_l, fint_l))
    ssacoliq = _to_g(_interp_rows(ssal, index_l, fint_l))
    # clamp the low-radius extrapolation overshoot (cldprmc_sw.F90:230-231)
    ssal_base = _to_g(jnp.broadcast_to(
        ssal[index_l - 1], fint_l.shape + (14,)))
    ssacoliq = jnp.where((fint_l[..., None, :] < 0.0) & (ssacoliq > 1.0),
                         ssal_base, ssacoliq)
    gliq = _to_g(_interp_rows(asyl, index_l, fint_l))
    forwliq = gliq * gliq

    has_liq = cldymc & (clwpmc > 0.0)
    extcoliq = jnp.where(has_liq, extcoliq, 0.0)
    ssacoliq = jnp.where(has_liq, ssacoliq, 0.0)
    gliq = jnp.where(has_liq, gliq, 0.0)
    forwliq = jnp.where(has_liq, forwliq, 0.0)

    tauliqorig = clwpmc * extcoliq
    tauiceorig = ciwpmc * extcoice
    taormc = tauliqorig + tauiceorig

    denl = 1.0 - forwliq * ssacoliq
    deni = 1.0 - forwice * ssacoice
    ssaliq = ssacoliq * (1.0 - forwliq) / jnp.maximum(denl, 1e-12)
    ssaice = ssacoice * (1.0 - forwice) / jnp.maximum(deni, 1e-12)
    tauliq = denl * tauliqorig
    tauice = deni * tauiceorig
    scatliq = ssaliq * tauliq
    scatice = jnp.maximum(ssaice * tauice, jnp.where(has_ice | has_liq,
                                                     _CLDMIN, 0.0))
    taucmc = tauliq + tauice
    taucmc = jnp.where(cldymc & (taucmc == 0.0), _CLDMIN, taucmc)
    ssacmc = jnp.where(cldymc,
                       (scatliq + scatice) / jnp.maximum(taucmc, _CLDMIN),
                       1.0)

    gl_d = (gliq - forwliq) / jnp.maximum(1.0 - forwliq, 1e-12)
    gi_d = (gice - forwice) / jnp.maximum(1.0 - forwice, 1e-12)
    scat_tot = jnp.maximum(scatliq + scatice, 1e-30)
    asmcmc = jnp.where(cldymc,
                       (scatliq * gl_d + scatice * gi_d) / scat_tot, 0.0)
    taucmc = jnp.where(cldymc, taucmc, 0.0)
    taormc = jnp.where(cldymc, taormc, 0.0)
    return taucmc, ssacmc, asmcmc, taormc
