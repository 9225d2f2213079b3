"""RRTMG-LW no-scattering radiative transfer with McICA clouds (rtrnmc).

Re-derivation of rrtmg_lw_rtrnmc.F90:27-392 with these changes:
* the exp/tau/tfn lookup tables (rrlw_tbl, ntbl=10000) are replaced by exact
  evaluation, so the "discretized tau" consistency dance
  (rtrnmc.F90:196-254) becomes unnecessary;
* the downward and upward sweeps are lax.scans over layers with all
  (column, g-point) lanes vectorized;
* the clear/total downward stream divergence logic (rtrnmc.F90:288-301)
  becomes a cumulative-OR mask.

Vertical ordering here: TOA first (index 0 = top layer), levels [0] = TOA.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

from .tables_lw import NG_LW

_WTDIFF = 0.5
_FLUXFAC = np.pi * 2.0e4
_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                      1180., 1390., 1480., 1800., 2080., 2250., 2380., 2600.])
_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080., 1180.,
                      1390., 1480., 1800., 2080., 2250., 2380., 2600., 3250.])
_DELWAVE = _WAVENUM2 - _WAVENUM1
_NGB = np.repeat(np.arange(16), NG_LW)
_DELWAVE_G = (_WTDIFF * _DELWAVE * _FLUXFAC)[_NGB]

# variable diffusivity-angle coefficients (rtrnmc.F90:131-146)
_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
_A1 = np.array([0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
                -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
_A2 = np.array([0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19, -0.062,
                0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
_VARIABLE_SECDIFF = np.array(
    [False, True, True, False, True, True, True, True, True,
     False, False, False, False, False, False, False])


def diffusivity_secant(pwvcm, dtype):
    """Diffusivity secant per column and band [ncol, 16]: water-vapour
    dependent in the variable bands (rtrnmc.F90:131-146), 1.66 elsewhere."""
    return jnp.where(
        jnp.asarray(_VARIABLE_SECDIFF)[None, :],
        jnp.clip(jnp.asarray(_A0, dtype)[None, :]
                 + jnp.asarray(_A1, dtype)[None, :]
                 * jnp.exp(jnp.asarray(_A2, dtype)[None, :] * pwvcm[:, None]),
                 1.5, 1.8),
        1.66)


def _tfn(tau):
    """Linear-in-tau Planck transition function (rrtmg_lw_init.F90:96-114),
    evaluated exactly; series form below the reference's 0.06 switch."""
    tr = jnp.exp(-tau)
    safe_tau = jnp.maximum(tau, 1e-9)
    direct = 1.0 - 2.0 * (1.0 / safe_tau - tr / jnp.maximum(1.0 - tr, 1e-12))
    return jnp.where(tau < 0.06, tau / 6.0, direct)


def rtrnmc(semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
           plankbnd, dplankbnd_dts, pwvcm, dudts=True):
    """LW fluxes via diffusivity-angle RT.

    Shapes (TOA-first):
      semiss:   [ncol, 16]
      taug, pfracs, taucmc: [ncol, nlay, ngpt]
      cloudy:   [ncol, nlay] bool (any g-point optically cloudy)
      planklay: [ncol, nlay, 16]; planklev: [ncol, nlay+1, 16]
      plankbnd, dplankbnd_dts: [ncol, 16]; pwvcm: [ncol]

    Returns dict of [ncol, nlay+1] fluxes (W/m^2, TOA-first, all positive):
      uflx, dflx, uflxc, dflxc, duflx_dts, duflxc_dts.
    """
    dtype = taug.dtype
    ncol, nlay, ngpt = taug.shape

    delwave_g = jnp.asarray(_DELWAVE_G, dtype)
    secdiff = diffusivity_secant(pwvcm, dtype)[:, _NGB]   # [ncol, ngpt]

    plfrac = pfracs
    blay = planklay[:, :, _NGB]                   # [ncol, nlay, ngpt]
    # TOA-first: layer k spans levels k (top) and k+1 (bottom)
    dplankup = planklev[:, :-1, :][:, :, _NGB] - blay
    dplankdn = planklev[:, 1:, :][:, :, _NGB] - blay

    odepth = jnp.maximum(secdiff[:, None, :] * taug, 0.0)
    odcld = secdiff[:, None, :] * taucmc
    odtot = odepth + odcld

    agas = 1.0 - jnp.exp(-odepth)
    atot = 1.0 - jnp.exp(-odtot)
    tfacgas = _tfn(odepth)
    tfactot = _tfn(odtot)

    bbdgas = plfrac * (blay + tfacgas * dplankdn)
    bbugas = plfrac * (blay + tfacgas * dplankup)
    bbdtot = plfrac * (blay + tfactot * dplankdn)
    bbutot = plfrac * (blay + tfactot * dplankup)

    cld = taucmc > 0.0
    a_eff = jnp.where(cld, atot, agas)
    bbd_eff = jnp.where(cld, bbdtot, bbdgas)
    bbu_eff = jnp.where(cld, bbutot, bbugas)

    # divergence mask: once a layer above (inclusive) is cloudy
    diverged = jnp.cumsum(cloudy.astype(jnp.int32), axis=1) > 0  # [ncol,nlay]

    # ---- downward sweep (TOA -> surface) ----
    def down_step(carry, xs):
        radld, radclrd = carry
        bbd, a, bbdg, ag, div = xs
        radld_n = radld + (bbd - radld) * a
        radclr_n = jnp.where(div[:, None],
                             radclrd + (bbdg - radclrd) * ag, radld_n)
        return (radld_n, radclr_n), (radld_n, radclr_n)

    xs = (jnp.moveaxis(bbd_eff, 1, 0), jnp.moveaxis(a_eff, 1, 0),
          jnp.moveaxis(bbdgas, 1, 0), jnp.moveaxis(agas, 1, 0),
          jnp.moveaxis(diverged, 1, 0))
    zero = jnp.zeros((ncol, ngpt), dtype)
    (radld_sfc, radclrd_sfc), (radld_seq, radclrd_seq) = lax.scan(
        down_step, (zero, zero), xs)
    # radld_seq[k] = radiance at level k+1; prepend TOA zeros
    radld_lev = jnp.concatenate([zero[None], radld_seq], axis=0)
    radclrd_lev = jnp.concatenate([zero[None], radclrd_seq], axis=0)

    dflx = jnp.einsum("lcg,g->cl", radld_lev, delwave_g,
        precision="highest")
    dflxc = jnp.einsum("lcg,g->cl", radclrd_lev, delwave_g,
        precision="highest")

    # ---- surface ----
    pf_sfc = pfracs[:, -1, :]                     # bottom layer Planck fracs
    rad0 = pf_sfc * plankbnd[:, _NGB]
    reflect = (1.0 - semiss)[:, _NGB]
    radlu0 = rad0 + reflect * radld_sfc
    radclru0 = rad0 + reflect * radclrd_sfc
    d_rad0 = pf_sfc * dplankbnd_dts[:, _NGB]

    # ---- upward sweep (surface -> TOA) ----
    # In the reference the divergence flag is NOT updated during the upward
    # loop: it is the final downward value = "any layer cloudy in column"
    # (surface reflection differs between streams; rtrnmc.F90:344-352).
    div_any = diverged[:, -1][:, None]            # [ncol, 1]

    def up_step(carry, xs):
        radlu, radclru, dlu, dclru = carry
        bbu, a, bbug, ag = xs
        radlu_n = radlu + (bbu - radlu) * a
        dlu_n = dlu * (1.0 - a)
        radclru_n = jnp.where(div_any,
                              radclru + (bbug - radclru) * ag, radlu_n)
        dclru_n = jnp.where(div_any, dclru * (1.0 - ag), dlu_n)
        return (radlu_n, radclru_n, dlu_n, dclru_n), \
            (radlu_n, radclru_n, dlu_n, dclru_n)

    xs_up = tuple(x[::-1] for x in
                  (jnp.moveaxis(bbu_eff, 1, 0), jnp.moveaxis(a_eff, 1, 0),
                   jnp.moveaxis(bbugas, 1, 0), jnp.moveaxis(agas, 1, 0)))
    carry0 = (radlu0, radclru0, d_rad0, d_rad0)
    _, (radlu_seq, radclru_seq, dlu_seq, dclru_seq) = lax.scan(
        up_step, carry0, xs_up)
    # radlu_seq[i] = radiance at level nlay-1-i; level nlay (surface) = radlu0
    radlu_lev = jnp.concatenate([radlu_seq[::-1], radlu0[None]], axis=0)
    radclru_lev = jnp.concatenate([radclru_seq[::-1], radclru0[None]], axis=0)
    dlu_lev = jnp.concatenate([dlu_seq[::-1], d_rad0[None]], axis=0)
    dclru_lev = jnp.concatenate([dclru_seq[::-1], d_rad0[None]], axis=0)

    uflx = jnp.einsum("lcg,g->cl", radlu_lev, delwave_g,
        precision="highest")
    uflxc = jnp.einsum("lcg,g->cl", radclru_lev, delwave_g,
        precision="highest")
    out = dict(uflx=uflx, dflx=dflx, uflxc=uflxc, dflxc=dflxc)
    if dudts:
        out["duflx_dts"] = jnp.einsum("lcg,g->cl", dlu_lev, delwave_g,
        precision="highest")
        out["duflxc_dts"] = jnp.einsum("lcg,g->cl", dclru_lev, delwave_g,
        precision="highest")
    # band OLR: top-level radiances per band (OLRBRG export,
    # rrtmg_lw_rtrnmc.F90 band_output path)
    olrb = jnp.zeros((ncol, 16), dtype).at[:, _NGB].add(
        radlu_lev[0] * delwave_g)
    out["olrb"] = olrb
    if dudts:
        # band d(OLR)/dTs (DOLRBRG_DTS) for the Ts-linearized band-OLR
        # advance in Update_Flx (GEOS_IrradGridComp.F90:3994-4009)
        out["dolrb_dts"] = jnp.zeros((ncol, 16), dtype).at[:, _NGB].add(
            dlu_lev[0] * delwave_g)
    return out
