"""RRTMG-LW all-sky McICA driver (the reference's rrtmg_lw / rrtmg_lw_part).

Pipeline per rrtmg_lw_rad.F90:348-610: stochastic subcolumn generation ->
clear counts -> cloud optical depths -> setcoef -> taumol -> rtrnmc.
No partition loop: XLA tiles the column batch; callers shard/block columns.

All inputs TOA-first. Water paths are IN-CLOUD values in g/m^2.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ...constants import GRAV, RGAS, AMD
from ...ops.mcica import generate_stochastic_clouds, clear_counts_three_band
from .cldprmc_lw import cldprmc_lw
from .rtrnmc_gpu import rtrnmc_for_platform
from .setcoef_lw import setcoef_lw
from .taumol_lw import taumol_lw
from .tables_lw import NGPTLW


def level_temperatures(play, tlay, plev, tsfc):
    """Interpolate layer temperatures to levels (TOA-first).

    Interior levels: linear-in-p between adjacent layers; TOA level copies
    the top layer; the surface level uses tsfc.
    """
    wt = (plev[..., 1:-1] - play[..., :-1]) \
        / (play[..., 1:] - play[..., :-1])
    interior = tlay[..., :-1] + wt * (tlay[..., 1:] - tlay[..., :-1])
    return jnp.concatenate(
        [tlay[..., :1], interior, tsfc[..., None]], axis=-1)


def mid_heights(play, tlay, psfc):
    """Approximate layer-midpoint heights via the hypsometric equation.

    Only height DIFFERENCES matter (decorrelation lengths in the subcolumn
    generator), so the zero reference is arbitrary.
    """
    rd = RGAS / (AMD * 1e-3)      # ~287 J/kg/K
    # integrate from surface upward: z ~ sum rd*T/g * dln(p)
    lnp = jnp.log(play)
    dz_half = rd * tlay / GRAV
    # z_mid[k] = sum over layers below of rd*T*dlnp (TOA-first: reverse)
    dlnp = jnp.diff(lnp, axis=-1)                    # [nlay-1], positive
    tmid = 0.5 * (tlay[..., 1:] + tlay[..., :-1])
    seg = rd * tmid / GRAV * dlnp
    # height of layer k relative to the bottom layer
    z_rel = jnp.concatenate(
        [jnp.cumsum(seg[..., ::-1], axis=-1)[..., ::-1],
         jnp.zeros_like(tlay[..., :1])], axis=-1)
    del dz_half
    return z_rel


@partial(jax.jit, static_argnames=("iceflag", "liqflag", "dudts",
                                   "cloud_mh", "cloud_lm", "inhm"))
def rrtmg_lw(ple, play, tlay, tlev, tsfc, emis,
             h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, covmr,
             cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
             cldf, ciwp, clwp, rei, rel, zm, alat, doy,
             taua=None, *, iceflag=3, liqflag=1, dudts=True,
             cloud_mh=1, cloud_lm=2, inhm=1):
    """RRTMG LW all-sky fluxes with McICA clouds.

    Args (all TOA-first):
      ple:  [ncol, nlay+1] level pressure (Pa)
      play: [ncol, nlay] layer pressure (hPa); tlay [K]; tlev [ncol, nlay+1]
      tsfc: [ncol]; emis: [ncol, 16]
      gas vmrs: [ncol, nlay]
      cldf: [ncol, nlay]; ciwp/clwp in-cloud water paths (g/m^2);
      rei/rel: particle sizes (micron; rei meaning depends on iceflag)
      zm: [ncol, nlay] layer mid heights (m); alat [rad]; doy scalar
      taua: optional [ncol, nlay, 16] aerosol optical depth
      cloud_mh/cloud_lm: static super-layer boundary layer indices (1-based,
        TOA-first, GEOS LCLDMH/LCLDLM) for clear-subcolumn counts

    Returns dict: uflx, dflx, uflxc, dflxc [ncol, nlay+1] (W/m^2, positive),
    duflx_dts, duflxc_dts, olrb [ncol, 16], clear_counts [ncol, 4].
    """
    plev = ple * 0.01

    scope = jax.named_scope
    with scope("lw.mcica"):
        cldy, ciwp_s, clwp_s = generate_stochastic_clouds(
            zm, alat, doy, play, cldf, ciwp, clwp, 1.0e-20,
            nsubcol=NGPTLW, inhm=inhm, seed_order=(0, 1, 2, 3))
        counts = clear_counts_three_band(cldy, cloud_mh, cloud_lm)

    with scope("lw.cldprmc"):
        taucmc_gl, cloudy = cldprmc_lw(cldy, ciwp_s, clwp_s, rei, rel,
                                       iceflag=iceflag, liqflag=liqflag)
        taucmc = jnp.swapaxes(taucmc_gl, -1, -2)  # [ncol, nlay, ngpt]

    with scope("lw.setcoef"):
        coefs = setcoef_lw(play, tlay, plev, tlev, tsfc, emis,
                           h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr,
                           covmr, cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
                           dudts=dudts)

    with scope("lw.taumol"):
        taug, pfracs = taumol_lw(coefs, taua)

    with scope("lw.rtrnmc"):
        out = rtrnmc_for_platform(emis, taug, pfracs, cloudy, taucmc,
                                  coefs.planklay, coefs.planklev,
                                  coefs.plankbnd, coefs.dplankbnd_dts,
                                  coefs.pwvcm, dudts=dudts)
    out["clear_counts"] = counts
    return out
