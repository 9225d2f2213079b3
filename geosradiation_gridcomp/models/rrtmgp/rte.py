"""Generic radiative-transfer equation solvers over optical properties.

Equivalents of the external RRTMGP library's rte_sw (two-stream +
adding, ty_optical_props_2str) and rte_lw (no-scattering transport)
called by the reference GCs (GEOS_SolarGridComp.F90 'rte_sw',
GEOS_IrradGridComp.F90 'rte_lw'). They reuse this package's PIFM
two-stream reflectance/transmittance and scan-based vertical adding
(models/rrtmg/spcvmc.py) and the variable-diffusivity LW transport
(models/rrtmg/rtrnmc.py), but take GENERIC per-g-point optical
properties so any k-distribution backend and any cloud/aerosol optics
can drive them.
"""

import jax.numpy as jnp

from ..rrtmg.rtrnmc import rtrnmc
from ..rrtmg.spcvmc import reftra_sw, vrtqdr_sw


def rte_sw(taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
           sfc_alb_dir, sfc_alb_dif, band_lims_gpt,
           tau_aer=None, ssa_aer=None, g_aer=None, delta_scale=True):
    """Broadband SW fluxes from per-g-point optical properties.

    Args (TOA-first):
      taug/taur: [ncol, nlay, ngpt] gas and Rayleigh optical depths.
      tau_cld/ssa_cld/g_cld: [ncol, nlay, ngpt] cloud optics (zeros in
        clear cells - McICA-sampled via sampling.draw_samples).
      toa_src: [ncol, ngpt] direct-beam source at TOA (W/m^2 per gpt,
        normal to the beam); mu0: [ncol].
      sfc_alb_dir/dif: [ncol, nbnd] per-band surface albedos.
      band_lims_gpt: [nbnd, 2] static 1-based g-point limits.
      tau_aer/ssa_aer/g_aer: optional [ncol, nlay, nbnd] aerosol optics.

    Returns dict: flux_up, flux_dn, flux_dir [ncol, nlev+1] (W/m^2).
    """
    import numpy as np
    lims = np.asarray(band_lims_gpt)
    ngpt = taug.shape[-1]
    gpt2band = np.zeros(ngpt, np.int32)
    for b, (g1, g2) in enumerate(lims):
        gpt2band[int(g1) - 1:int(g2)] = b
    idx = jnp.asarray(gpt2band)

    if delta_scale:
        f = g_cld * g_cld
        tau_c = (1.0 - ssa_cld * f) * tau_cld
        ssa_c = jnp.where(tau_cld > 0.0,
                          (1.0 - f) * ssa_cld
                          / jnp.maximum(1.0 - ssa_cld * f, 1e-12), 0.0)
        g_c = jnp.where(tau_cld > 0.0,
                        (g_cld - f) / jnp.maximum(1.0 - f, 1e-12), 0.0)
    else:
        tau_c, ssa_c, g_c = tau_cld, ssa_cld, g_cld

    tau = taug + taur + tau_c
    scat = taur + ssa_c * tau_c
    asym = g_c * ssa_c * tau_c
    if tau_aer is not None:
        ta = tau_aer[..., idx]
        sa = (ssa_aer if ssa_aer is not None else 1.0)
        sa = sa[..., idx] if hasattr(sa, "ndim") and sa.ndim == 3 else sa
        ga = (g_aer if g_aer is not None else 0.0)
        ga = ga[..., idx] if hasattr(ga, "ndim") and ga.ndim == 3 else ga
        tau = tau + ta
        scat = scat + sa * ta
        asym = asym + ga * sa * ta
    w = jnp.clip(scat / jnp.maximum(tau, 1e-12), 0.0, 1.0 - 1e-6)
    g_eff = asym / jnp.maximum(scat, 1e-12)

    mu0c = jnp.maximum(mu0, 1e-6)
    ref, tra, refd, trad = reftra_sw(tau, w, g_eff, mu0c)
    # direct-beam transmittance: per layer and cumulative at levels
    dbt_lay = jnp.exp(-jnp.minimum(tau / mu0c[:, None, None], 500.0))
    tdbt = jnp.cumprod(dbt_lay, axis=1)
    tdbt = jnp.concatenate([jnp.ones_like(tdbt[:, :1]), tdbt], axis=1)
    albdir = sfc_alb_dir[..., idx]
    albdif = sfc_alb_dif[..., idx]
    fd, fu = vrtqdr_sw(ref, tra, refd, trad, albdir, albdif,
                       dbt_lay, tdbt)
    inc = toa_src * mu0c[:, None]         # vertical flux per gpt
    flux_up = jnp.einsum("clg,cg->cl", fu, inc, precision="highest")
    flux_dn = jnp.einsum("clg,cg->cl", fd, inc, precision="highest")
    flux_dir = jnp.einsum("clg,cg->cl", tdbt, inc, precision="highest")
    return dict(flux_up=flux_up, flux_dn=flux_dn, flux_dir=flux_dir)


def rte_lw(taug, sources, sfc_emis, tau_cld=None, cld_mask=None,
           dudts=False):
    """Broadband LW fluxes from per-g-point optical depths and Planck
    sources (no-scattering transport with the variable diffusivity
    angle of rtrnmc).

    taug: [ncol, nlay, ngpt]; sources: dict from KDistLW.gas_optics;
    sfc_emis: [ncol, nbnd]; tau_cld: optional McICA per-g-point cloud
    absorption optical depth; cld_mask: [ncol, nlay] any-gpt-cloudy.

    Returns dict: flux_up, flux_dn, flux_up_clr, flux_dn_clr, olrb
    (+ duflx_dts when dudts).
    """
    if tau_cld is None:
        tau_cld = jnp.zeros_like(taug)
        cloudy = jnp.zeros(taug.shape[:2], bool)
    else:
        cloudy = cld_mask if cld_mask is not None \
            else (tau_cld > 0.0).any(axis=-1)
    out = rtrnmc(sfc_emis, taug, sources["pfracs"], cloudy, tau_cld,
                 sources["planklay"], sources["planklev"],
                 sources["plankbnd"], sources["dplankbnd_dts"],
                 sources["pwvcm"], dudts=dudts)
    return dict(flux_up=out["uflx"], flux_dn=out["dflx"],
                flux_up_clr=out["uflxc"], flux_dn_clr=out["dflxc"],
                olrb=out["olrb"],
                **({"duflx_dts": out["duflx_dts"],
                    "duflxc_dts": out["duflxc_dts"],
                    "dolrb_dts": out["dolrb_dts"]} if dudts else {}))
