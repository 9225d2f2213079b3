"""Band-agnostic LW RTE for native k-distributions (rte_lw equivalent).

The shipped rte.rte_lw delegates to the RRTMG rtrnmc internals, which
hard-code the 16-band/140-g layout (band wavenumber widths, per-band
secdiff fits). A NATIVE k-distribution (models/rrtmgp/gas_optics.py)
can carry any band structure, so this module provides the generic
no-scattering solve: linear-in-tau Planck sources per g-point, fixed
diffusivity angle (RRTMGP's 1-angle default, secdiff = 1.66), surface
emission + reflection, down then up scans as lax.scans over layers.

Source units contract: sources["planklay"/"planklev"/"plankbnd"] are
BAND-INTEGRATED Planck fluxes [W/m^2] (pi*B integrated over the band);
g-point sources are pfracs * planck(band). RRTMGP's totplnk tables are
in these units after the ingest tool's pass-through.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax


def _tfn(od):
    tr = jnp.exp(-od)
    safe = jnp.maximum(od, 1e-9)
    direct = 1.0 - 2.0 * (1.0 / safe - tr / jnp.maximum(1.0 - tr,
                                                        1e-12))
    return jnp.where(od < 0.06, od / 6.0, direct)


def rte_lw_native(taug, sources, emis_bnd, band_lims_gpt,
                  tau_cld=None, secdiff=1.66, dudts=False):
    """Generic LW fluxes.

    taug: [ncol, nlay, ngpt]; emis_bnd [ncol, nbnd];
    band_lims_gpt [nbnd, 2] 1-based inclusive; tau_cld optional
    [ncol, nlay, ngpt] (absorption).
    Returns dict uflx/dflx/uflxc/dflxc [ncol, nlay+1] (W/m^2) and
    olrb [ncol, nbnd]; with dudts, also duflx_dts/duflxc_dts
    [ncol, nlay+1] and dolrb_dts [ncol, nbnd] — the analytic upward
    Jacobian: d(rad0)/dTs = emis*pfrac_sfc*dplankbnd_dts attenuated by
    prod(1-a) toward TOA (the same Ts-only linearization the reference
    stores as DUFLX_DT, rrtmg_lw_rad.F90 duflx_dt output).
    """
    ncol, nlay, ngpt = taug.shape
    lims = np.asarray(band_lims_gpt)
    nbnd = lims.shape[0]
    gband = np.zeros(ngpt, np.int64)
    for b in range(nbnd):
        gband[lims[b, 0] - 1:lims[b, 1]] = b
    e_bg = jnp.asarray(np.eye(nbnd, dtype=np.float32)[gband])

    pf = sources["pfracs"]
    lay_g = pf * sources["planklay"][..., gband]
    lev_g = sources["planklev"][..., gband]      # [ncol, nlay+1, ngpt]
    sfc_g = pf[:, -1, :] * sources["plankbnd"][..., gband]
    emis_g = emis_bnd[..., gband]

    tau_tot = taug if tau_cld is None else taug + tau_cld

    # linear-in-tau Planck (rtrnmc method doc, rrtmg_lw_rtrnmc.F90:39-61):
    # the source toward a boundary blends the boundary-level Planck with
    # the layer mean via the pade-style tfn factor
    odl = jnp.maximum(secdiff * tau_tot, 0.0)
    a_all = 1.0 - jnp.exp(-odl)
    tf_all = _tfn(odl)
    odc = jnp.maximum(secdiff * taug, 0.0)
    a_clr = 1.0 - jnp.exp(-odc)
    tf_clr = _tfn(odc)
    blev_below = lev_g[:, 1:, :] * pf
    blev_above = lev_g[:, :-1, :] * pf

    dsfc_g = (emis_g * pf[:, -1, :]
              * sources["dplankbnd_dts"][..., gband]) if dudts else None

    def fluxes(a, tf):
        bbd = blev_below + tf * (lay_g - blev_below)
        bbu = blev_above + tf * (lay_g - blev_above)

        def down(carry, xs):
            rad = carry
            a_l, s_l = xs
            rad = rad + (s_l - rad) * a_l
            return rad, rad

        a_l = jnp.moveaxis(a, 1, 0)
        _, rad_dn = lax.scan(down, jnp.zeros((ncol, ngpt), a.dtype),
                             (a_l, jnp.moveaxis(bbd, 1, 0)))
        dflx_lev = jnp.concatenate(
            [jnp.zeros((1, ncol, ngpt), a.dtype), rad_dn], axis=0)

        rad_sfc = rad_dn[-1]
        rad0 = emis_g * sfc_g + (1.0 - emis_g) * rad_sfc

        def up(carry, xs):
            rad = carry
            a_l, s_l = xs
            rad = rad + (s_l - rad) * a_l
            return rad, rad

        _, rad_up = lax.scan(up, rad0,
                             (a_l, jnp.moveaxis(bbu, 1, 0)),
                             reverse=True)
        uflx_lev = jnp.concatenate([rad_up, rad0[None]], axis=0)
        dflx = jnp.sum(dflx_lev, axis=-1).T
        uflx = jnp.sum(uflx_lev, axis=-1).T
        olrb = jnp.dot(uflx_lev[0], e_bg, precision="highest")
        if not dudts:
            return uflx, dflx, olrb, None, None
        # Ts Jacobian: the surface perturbation dsfc_g propagates up
        # attenuated by (1-a) per layer (rad' = rad*(1-a) + src*a)
        trn = jnp.concatenate(
            [jnp.cumprod((1.0 - a)[:, ::-1, :], axis=1)[:, ::-1, :],
             jnp.ones_like(a[:, :1, :])], axis=1)  # [ncol, nlay+1, ngpt]
        du_g = dsfc_g[:, None, :] * trn
        duflx = jnp.sum(du_g, axis=-1)
        dolrb = jnp.dot(du_g[:, 0, :], e_bg, precision="highest")
        return uflx, dflx, olrb, duflx, dolrb

    uflx, dflx, olrb, duflx, dolrb = fluxes(a_all, tf_all)
    uflxc, dflxc, _, duflxc, _ = fluxes(a_clr, tf_clr)
    out = dict(uflx=uflx, dflx=dflx, uflxc=uflxc, dflxc=dflxc,
               olrb=olrb)
    if dudts:
        out.update(duflx_dts=duflx, duflxc_dts=duflxc,
                   dolrb_dts=dolrb)
    return out


def rte_sw_native(taug, taur, toa_src, mu0, alb_dir_bnd, alb_dif_bnd,
                  band_lims_gpt, tau_cld=None, ssa_cld=None,
                  g_cld=None, tau_aer=None, ssa_aer=None, g_aer=None):
    """Band-agnostic SW two-stream + adding for native k-distributions.

    The PIFM layer R/T (reftra_sw) and the vrtqdr adding scans in
    models/rrtmg/spcvmc.py are already g-count-agnostic; only the band
    maps there are hard-coded, so this wrapper supplies generic ones.

    taug/taur [ncol, nlay, ngpt]; toa_src [ncol, ngpt] (W/m^2 per gpt at
    overhead sun); mu0 [ncol]; albedos [ncol, nbnd]; cloud optics
    optional [ncol, nlay, ngpt]. Returns flux_dn/flux_up/flux_dir,
    flux_dn_clr/flux_up_clr [ncol, nlay+1] plus band_dn_sfc
    [ncol, nbnd]. Night columns (mu0 <= 0) return zero fluxes, matching
    rrtmg_sw (models/rrtmg/sw.py day masking).
    """
    from ..rrtmg.spcvmc import reftra_sw, vrtqdr_sw

    ncol, nlay, ngpt = taug.shape
    lims = np.asarray(band_lims_gpt)
    nbnd = lims.shape[0]
    gband = np.zeros(ngpt, np.int64)
    for b in range(nbnd):
        gband[lims[b, 0] - 1:lims[b, 1]] = b
    e_bg = jnp.asarray(np.eye(nbnd, dtype=np.float32)[gband])
    mu0c = jnp.maximum(mu0, 1e-4)

    ref_sfc_dir = alb_dir_bnd[..., gband]
    ref_sfc_dif = alb_dif_bnd[..., gband]
    zincflx = toa_src * mu0c[:, None]

    def solve(tau, w, g):
        ref, tra, refd, trad = reftra_sw(tau, w, g, mu0c)
        dbt = jnp.exp(-jnp.minimum(tau / mu0c[:, None, None], 500.0))
        tdbt = jnp.concatenate(
            [jnp.ones_like(dbt[..., :1, :]),
             jnp.cumprod(dbt, axis=-2)], axis=-2)
        fd, fu = vrtqdr_sw(ref, tra, refd, trad, ref_sfc_dir,
                           ref_sfc_dif, dbt, tdbt)
        return fd, fu, tdbt

    # aerosols (band-resolved [ncol, nlay, nbnd], expanded to g-points)
    # enter BOTH sky states — "clear" means cloud-free, aerosol-laden
    # (GEOS_SolarGridComp aerosol optics added to clear + all-sky)
    base_tau, base_scat, base_asym = taug + taur, taur, 0.0
    if tau_aer is not None:
        ta_g = tau_aer[..., gband]
        sa_g = (ssa_aer if ssa_aer is not None
                else jnp.zeros_like(tau_aer))[..., gband]
        ga_g = (g_aer if g_aer is not None
                else jnp.zeros_like(tau_aer))[..., gband]
        base_tau = base_tau + ta_g
        base_scat = base_scat + sa_g * ta_g
        base_asym = ga_g * sa_g * ta_g
    w_clr = base_scat / jnp.maximum(base_tau, 1e-30)
    g_clr = base_asym / jnp.maximum(base_scat, 1e-30) \
        if tau_aer is not None else jnp.zeros_like(taug)
    fd_c, fu_c, dir_c = solve(base_tau, w_clr, g_clr)

    if tau_cld is None:
        fd_a, fu_a, dir_a = fd_c, fu_c, dir_c
    else:
        tt = base_tau + tau_cld
        scat = base_scat + ssa_cld * tau_cld
        g_all = (base_asym + g_cld * ssa_cld * tau_cld) \
            / jnp.maximum(scat, 1e-30)
        w_all = scat / jnp.maximum(tt, 1e-30)
        fd_a, fu_a, dir_a = solve(tt, w_all, g_all)

    day = (mu0 > 0.0).astype(taug.dtype)
    agg = lambda x: day[:, None] * jnp.einsum(
        "clg,cg->cl", x, zincflx, precision="highest")
    out = dict(flux_dn=agg(fd_a), flux_up=agg(fu_a),
               flux_dir=agg(dir_a),
               flux_dn_clr=agg(fd_c), flux_up_clr=agg(fu_c))
    out["band_dn_sfc"] = day[:, None] * jnp.einsum(
        "cg,gb->cb", fd_a[:, -1, :] * zincflx, e_bg,
        precision="highest")
    return out
