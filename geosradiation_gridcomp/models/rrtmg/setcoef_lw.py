"""RRTMG-LW setcoef: interpolation indices/fractions and Planck functions.

Re-derivation of rrtmg_lw_setcoef.F90:52-584 for batched [ncol, nlay]
arrays, TOA-last (RRTMG bottom-up ordering is NOT required: everything here
is per-layer local, and the troposphere/stratosphere split becomes a boolean
mask `lower` instead of the reference's laytrop counter).
"""

from typing import NamedTuple

import jax.numpy as jnp

from ...constants import GRAV, AVOGAD, AMD, AMW
from .tables_lw import lw_tables

_STPFAC = 296.0 / 1013.0


class LWCoefs(NamedTuple):
    """Per-layer interpolation state (all [..., nlay] unless noted)."""
    lower: jnp.ndarray          # bool: pavel > ~95.6 hPa (tropospheric set)
    jp: jnp.ndarray             # int, 1-based as in reference
    jt: jnp.ndarray
    jt1: jnp.ndarray
    fac00: jnp.ndarray
    fac01: jnp.ndarray
    fac10: jnp.ndarray
    fac11: jnp.ndarray
    selffac: jnp.ndarray
    selffrac: jnp.ndarray
    indself: jnp.ndarray
    forfac: jnp.ndarray
    forfrac: jnp.ndarray
    indfor: jnp.ndarray
    minorfrac: jnp.ndarray
    indminor: jnp.ndarray
    scaleminor: jnp.ndarray
    scaleminorn2: jnp.ndarray
    coldry: jnp.ndarray
    colbrd: jnp.ndarray
    colh2o: jnp.ndarray
    colco2: jnp.ndarray
    colo3: jnp.ndarray
    coln2o: jnp.ndarray
    colch4: jnp.ndarray
    colo2: jnp.ndarray
    colco: jnp.ndarray
    colcfc11: jnp.ndarray
    colcfc12: jnp.ndarray
    colcfc22: jnp.ndarray
    colccl4: jnp.ndarray
    pavel: jnp.ndarray
    pwvcm: jnp.ndarray          # [...]: precipitable water (cm)
    plankbnd: jnp.ndarray       # [..., nbnd]
    dplankbnd_dts: jnp.ndarray  # [..., nbnd]
    planklay: jnp.ndarray       # [..., nlay, nbnd]
    planklev: jnp.ndarray       # [..., nlay+1, nbnd]


def _planck_interp(table, t):
    """Linear interpolation of totplnk-style (181, nbnd) table at T [K]."""
    tt = jnp.asarray(table)
    ind = jnp.clip(jnp.floor(t - 159.0).astype(jnp.int32), 1, 180)
    frac = t - 159.0 - ind.astype(t.dtype)
    lo = tt[ind - 1]
    return lo + frac[..., None] * (tt[ind] - lo)


def setcoef_lw(pavel, tavel, pz, tz, tbound, semiss,
               h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, covmr,
               cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr, dudts=True):
    """Compute LWCoefs.

    pavel/tavel: [..., nlay] layer p [hPa] / T [K].
    pz/tz: [..., nlay+1] level p/T, ordered surface..TOA OR TOA..surface —
      must be consistent: pz[..., 0] is the SURFACE (pz(0) in the reference).
    tbound: [...] surface temperature; semiss: [..., 16].
    Gas vmrs: [..., nlay].
    """
    dtype = pavel.dtype
    t = lw_tables()
    preflog = jnp.asarray(t["preflog"], dtype)
    tref = jnp.asarray(t["tref"], dtype)
    chi = jnp.asarray(t["chi_mls"], dtype)
    del chi  # rat_* are computed in taumol from jp

    amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
    dpz = pz[..., :-1] - pz[..., 1:]    # positive if pz[0]=surface
    dpz = jnp.abs(dpz)
    coldry = dpz * 1.0e3 * AVOGAD / (1.0e2 * GRAV * amm * (1.0 + h2ovmr))

    summol = co2vmr + o3vmr + n2ovmr + ch4vmr + o2vmr
    wbroad = coldry * (1.0 - summol)
    wv_mol = h2ovmr * coldry
    amttl = jnp.sum(coldry + wv_mol, axis=-1)
    wvttl = jnp.sum(wv_mol, axis=-1)
    wvsh = (AMW * wvttl) / (AMD * amttl)
    psfc = jnp.maximum(pz[..., 0], pz[..., -1])
    pwvcm = wvsh * (1.0e3 * psfc) / (1.0e2 * GRAV)

    # Planck functions
    totplnk = t["totplnk"]
    plankbnd = semiss * _planck_interp(totplnk, tbound)
    dplankbnd = semiss * _planck_interp(t["totplnkderiv"], tbound) if dudts \
        else jnp.zeros_like(plankbnd)
    planklay = _planck_interp(totplnk, tavel)          # [..., nlay, 16]
    planklev = _planck_interp(totplnk, tz)             # [..., nlay+1, 16]

    plog = jnp.log(pavel)
    jp = jnp.clip(jnp.floor(36.0 - 5.0 * (plog + 0.04)).astype(jnp.int32),
                  1, 58)
    fp = 5.0 * (preflog[jp - 1] - plog)
    tj = (tavel - tref[jp - 1]) / 15.0
    jt = jnp.clip(jnp.floor(3.0 + tj).astype(jnp.int32), 1, 4)
    ft = tj - (jt - 3).astype(dtype)
    tj1 = (tavel - tref[jp]) / 15.0
    jt1 = jnp.clip(jnp.floor(3.0 + tj1).astype(jnp.int32), 1, 4)
    ft1 = tj1 - (jt1 - 3).astype(dtype)

    lower = plog > 4.56

    water = h2ovmr
    scalefac = pavel * _STPFAC / tavel
    forfac = scalefac / (1.0 + water)

    # foreign continuum index (lower: 1-2; upper: fixed 3)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = jnp.clip(jnp.floor(fac_lo).astype(jnp.int32), 1, 2)
    forfrac_lo = fac_lo - indfor_lo.astype(dtype)
    fac_up = (tavel - 188.0) / 36.0
    indfor = jnp.where(lower, indfor_lo, 3)
    forfrac = jnp.where(lower, forfrac_lo, fac_up - 1.0)

    # self continuum (lower only)
    fac_s = (tavel - 188.0) / 7.2
    indself = jnp.clip(jnp.floor(fac_s).astype(jnp.int32) - 7, 1, 9)
    selffrac = fac_s - (indself + 7).astype(dtype)
    selffac = jnp.where(lower, water * forfac, 0.0)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wv_mol))
    fac_m = (tavel - 180.8) / 7.2
    indminor = jnp.clip(jnp.floor(fac_m).astype(jnp.int32), 1, 18)
    minorfrac = fac_m - indminor.astype(dtype)

    def col(vmr):
        return 1.0e-20 * vmr * coldry

    def col_floor(vmr):
        c = col(vmr)
        return jnp.where(c == 0.0, 1.0e-32 * coldry, c)

    colh2o = col(h2ovmr)
    colco2 = col_floor(co2vmr)
    colo3 = col_floor(o3vmr)
    coln2o = col_floor(n2ovmr)
    colch4 = col_floor(ch4vmr)
    colco = col_floor(covmr)
    colo2 = col(o2vmr)

    compfp = 1.0 - fp
    fac10 = compfp * ft
    fac00 = compfp * (1.0 - ft)
    fac11 = fp * ft1
    fac01 = fp * (1.0 - ft1)

    selffac = colh2o * selffac
    forfac = colh2o * forfac

    return LWCoefs(
        lower=lower, jp=jp, jt=jt, jt1=jt1,
        fac00=fac00, fac01=fac01, fac10=fac10, fac11=fac11,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor,
        minorfrac=minorfrac, indminor=indminor,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        coldry=coldry, colbrd=1.0e-20 * wbroad,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colch4=colch4, colo2=colo2, colco=colco,
        colcfc11=col(cfc11vmr), colcfc12=col(cfc12vmr),
        colcfc22=col(cfc22vmr), colccl4=col(ccl4vmr),
        pavel=pavel, pwvcm=pwvcm,
        plankbnd=plankbnd, dplankbnd_dts=dplankbnd,
        planklay=planklay, planklev=planklev)
