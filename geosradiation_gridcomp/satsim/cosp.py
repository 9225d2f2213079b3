"""COSP orchestration: the satellite-simulator driver.

Re-derivation of the reference's GEOS_SatsimGridComp.F90 SIM_DRIVER
(:2799-5020), cosp.F90 COSP/cosp_iter (:41-578) and
cosp_simulator.F90 dispatch: in-cloud condensate prep, Chou-optics
0.67um optical depths and 10.5um emissivities (getvistau/getirtau band
4, GEOS_SatsimGridComp.F90:3425-3452), SCOPS subcolumns + precip
occurrence, gridbox-mean -> subcolumn hydrometeor distribution with
sampled-fraction normalization (cosp.F90:451-520), then the ISCCP,
MISR, MODIS, CALIPSO and CloudSat simulators and their statistics.

One jit-compiled pipeline per configuration; the reference's
SATSIM_POINTS_PER_ITERATION chunking is unnecessary (XLA tiles), but a
`points_per_iteration` microbatching hook is kept for memory control on
very large domains.

Hydrometeor class order (cosp_constants.F90:116): LSL, LSI, LSR, LSS,
CVL, CVI, CVR, CVS, LSG. GEOS feeds zero convective species
(GEOS_SatsimGridComp.F90:3689-3692).
"""

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAV
from ..tables import load
from .scops import scops, prec_scops
from .icarus import isccp_simulator
from .misr import misr_simulator
from .modis import modis_l2_simulator, modis_l3_simulator
from .lidar import lidar_simulator, lidar_stats
from .radar import quickbeam_simulator, radar_cfad, lidar_only_freq_cloud
from .stats import change_vertical_grid, csat_vgrid_bounds

# class indices (cosp_constants hclass columns, 0-based)
I_LSCLIQ, I_LSCICE, I_LSRAIN, I_LSSNOW = 0, 1, 2, 3
I_CVCLIQ, I_CVCICE, I_CVRAIN, I_CVSNOW, I_LSGRPL = 4, 5, 6, 7, 8
N_HYDRO = 9

ISCCP_EMSFC_LW = 0.99   # 10.5um surface emissivity (COSP default)


class SatsimInputs(NamedTuple):
    """Satsim import state (GEOS_SatsimGridComp.F90:3076-3095), column
    batch, TOA-first."""
    ple: jnp.ndarray     # [np, nlev+1] edge pressure (Pa)
    zle: jnp.ndarray     # [np, nlev+1] edge heights (m)
    t: jnp.ndarray       # [np, nlev] temperature (K)
    qv: jnp.ndarray      # [np, nlev] specific humidity (kg/kg)
    fcld: jnp.ndarray    # [np, nlev] cloud fraction
    qi: jnp.ndarray      # grid-mean ice mixing ratio (kg/kg)
    ql: jnp.ndarray      # liquid
    qr: jnp.ndarray      # rain
    qs: jnp.ndarray      # snow
    qg: jnp.ndarray      # graupel
    ri: jnp.ndarray      # effective radii (m)
    rl: jnp.ndarray
    rr: jnp.ndarray
    rs: jnp.ndarray
    rg: jnp.ndarray
    ts: jnp.ndarray      # [np] skin temperature (K)
    mcosz: jnp.ndarray   # [np] mean cosine solar zenith
    frland: jnp.ndarray  # [np] land fraction


@dataclasses.dataclass(frozen=True)
class SatsimConfig:
    """Static simulator configuration (USE_SATSIM* resources +
    SATSIM_NCOLUMNS, GEOS_SatsimGridComp.F90:3058; COSP cfg flags)."""
    ncolumns: int = 50
    overlap: int = 3                    # ISCCP_OVERLAP (max-random)
    isccp_top_height: int = 1
    isccp_top_height_direction: int = 2
    lidar_ice_type: int = 0
    run_isccp: bool = True
    run_misr: bool = True
    run_modis: bool = True
    run_lidar: bool = True
    run_radar: bool = True
    # stat-grid regridding (CONSTRUCT_COSP_VGRID, cosp_types.F90:554-605;
    # COSP_STATS regrids CFAD inputs when use_vgrid, cosp_stats.F90:78-104)
    use_vgrid: bool = True
    csat_vgrid: bool = True                 # 480 m CloudSat spacing
    nlr: int = 40


def _chou_vis_tau(dp_pa, cwc, reff):
    """Unscaled 0.67um per-hydrometeor optical depths (getvistau.code
    with overlap scaling off, as called by SIM_DRIVER :3425)."""
    t = load("chou_rad_constants")
    aib = float(t["aib_uv"])
    awb = t["awb_uv"]
    arb = float(t["arb_uv"][0])
    wp = dp_pa * 1.0e3 / GRAV
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = jnp.minimum(reff[..., 3], 112.0)
    t1 = jnp.where(re_i > 0.0,
                   wp * cwc[..., 0] * aib / jnp.maximum(re_i, 1e-6), 0.0)
    t2 = wp * cwc[..., 1] * (awb[0] + awb[1] * re_l)
    t3 = wp * cwc[..., 2] * arb
    t4 = jnp.where(re_s > 0.0,
                   wp * cwc[..., 3] * aib / jnp.maximum(re_s, 1e-6), 0.0)
    return t1, t2, t3, t4


def _chou_ir_tau_band4(dp_pa, cwc, reff):
    """Per-hydrometeor 10.5um (band 4) optical depths (getirtau.code,
    SIM_DRIVER :3430-3452)."""
    t = load("chou_rad_constants")
    aib = t["aib_ir"]   # (3, 10)
    awb = t["awb_ir"]   # (4, 10)
    ib = 3              # band 4, 0-based
    wp = dp_pa * 1.0e3 / GRAV
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = jnp.minimum(reff[..., 3], 112.0)
    t1 = jnp.where(re_i > 0.0,
                   wp * cwc[..., 0]
                   * (aib[0, ib] + aib[1, ib]
                      / jnp.maximum(re_i, 1e-6) ** aib[2, ib]), 0.0)
    t2 = wp * cwc[..., 1] * (awb[0, ib] + (awb[1, ib] + (
        awb[2, ib] + awb[3, ib] * re_l) * re_l) * re_l)
    t3 = 0.00307 * wp * cwc[..., 2]
    t4 = jnp.where(re_s > 0.0,
                   wp * cwc[..., 3]
                   * (aib[0, ib] + aib[1, ib]
                      / jnp.maximum(re_s, 1e-6) ** aib[2, ib]), 0.0)
    return t1, t2, t3, t4


def _distribute(gb_mr, mask, frac):
    """Gridbox-mean -> subcolumn values: place gb value in masked
    subcolumns, normalized by the sampled occupancy fraction
    (cosp.F90:451-520)."""
    scale = jnp.where(frac > 0.0, 1.0 / jnp.maximum(frac, 1e-12), 0.0)
    return jnp.where(mask, (gb_mr * scale)[:, None, :], 0.0)


@partial(jax.jit, static_argnames=("config",))
def cosp_simulator(key, inp: SatsimInputs, config: SatsimConfig = None):
    """Run the configured satellite simulators on a column batch.

    Returns a dict of diagnostic groups: 'isccp', 'misr', 'modis',
    'lidar', 'radar' (present per config flags), plus 'frac_out'.
    """
    cfg = config or SatsimConfig()
    npnt, nlev = inp.t.shape
    ncol = cfg.ncolumns
    play = 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    dp = inp.ple[:, 1:] - inp.ple[:, :-1]
    zlo = 0.5 * (inp.zle[:, 1:] + inp.zle[:, :-1])

    # in-cloud condensate (SIM_DRIVER :3377-3390) and radii in um
    icq = jnp.where(inp.fcld > 0.01,
                    1.0 / jnp.maximum(inp.fcld, 1e-6), 0.0)
    cwc = jnp.stack([jnp.maximum(inp.qi * icq, 1e-12) * (icq > 0),
                     jnp.maximum(inp.ql * icq, 1e-12) * (icq > 0),
                     jnp.maximum(inp.qr * icq, 1e-12) * (icq > 0),
                     jnp.maximum(inp.qs * icq, 1e-12) * (icq > 0)],
                    axis=-1)
    reff_um = jnp.stack([inp.ri, inp.rl, inp.rr, inp.rs],
                        axis=-1) * 1e6

    # 0.67um optical depth and 10.5um emissivity (ice+liquid only,
    # SIM_DRIVER :3437-3452)
    v1, v2, _, _ = _chou_vis_tau(dp, cwc, reff_um)
    dtau_s = v1 + v2
    i1, i2, _, _ = _chou_ir_tau_band4(dp, cwc, reff_um)
    dem_s = -jnp.expm1(-(i1 + i2))
    zeros = jnp.zeros_like(dtau_s)

    # subcolumn sampling; GEOS has no separate convective cloud
    frac_out = scops(key, inp.fcld, zeros, ncol, overlap=cfg.overlap)
    ls_cld = frac_out == 1

    # precip occurrence from total LS/CV precip mixing ratios
    # (cosp.F90:404-411; mixing-ratio mode, use_precipitation_fluxes=F)
    pf = prec_scops(inp.qr + inp.qs + inp.qg, jnp.zeros_like(inp.qr),
                    frac_out)
    ls_prec = (pf == 1) | (pf == 3)

    frac_ls = ls_cld.mean(axis=1)        # sampled LS cloud fraction
    prec_ls = ls_prec.mean(axis=1)

    # subcolumn hydrometeor mixing ratios [kg/kg] (cosp.F90:451-520)
    mr = {
        I_LSCLIQ: _distribute(inp.ql, ls_cld, frac_ls),
        I_LSCICE: _distribute(inp.qi, ls_cld, frac_ls),
        I_LSRAIN: _distribute(inp.qr, ls_prec, prec_ls),
        I_LSSNOW: _distribute(inp.qs, ls_prec, prec_ls),
        I_LSGRPL: _distribute(inp.qg, ls_prec, prec_ls),
    }
    re_cld = {  # um, gridbox radii in cloudy/precip subcolumns
        I_LSCLIQ: jnp.where(ls_cld, (inp.rl * 1e6)[:, None, :], 0.0),
        I_LSCICE: jnp.where(ls_cld, (inp.ri * 1e6)[:, None, :], 0.0),
        I_LSRAIN: jnp.where(ls_prec, (inp.rr * 1e6)[:, None, :], 0.0),
        I_LSSNOW: jnp.where(ls_prec, (inp.rs * 1e6)[:, None, :], 0.0),
        I_LSGRPL: jnp.where(ls_prec, (inp.rg * 1e6)[:, None, :], 0.0),
    }

    out = {"frac_out": frac_out}
    sunlit = (inp.mcosz > 0.0).astype(jnp.int32)

    isccp = None
    if cfg.run_isccp or cfg.run_modis:
        isccp = isccp_simulator(
            frac_out, play, inp.ple, inp.qv, inp.t, inp.ts,
            ISCCP_EMSFC_LW, dtau_s, zeros, dem_s, zeros, sunlit,
            top_height=cfg.isccp_top_height,
            top_height_direction=cfg.isccp_top_height_direction)
        if cfg.run_isccp:
            out["isccp"] = isccp

    if cfg.run_misr:
        out["misr"] = misr_simulator(frac_out, zlo, inp.t, dtau_s,
                                     zeros, sunlit)

    if cfg.run_modis:
        # per-subcolumn liquid/ice tau: dtau_s partitioned by the
        # geometric-optics LWC/re ratio (modis_L2_simulator_oneTau)
        lw = mr[I_LSCLIQ] / jnp.maximum((inp.rl * 1e6)[:, None, :],
                                        1e-6)
        iw = mr[I_LSCICE] / (0.93 * jnp.maximum(
            (inp.ri * 1e6)[:, None, :], 1e-6))
        liq_frac = jnp.where(lw + iw > 0.0,
                             lw / jnp.maximum(lw + iw, 1e-30), 0.0)
        tau_sub = jnp.where(ls_cld, dtau_s[:, None, :], 0.0)
        l2 = modis_l2_simulator(
            inp.t, play, inp.ple,
            tau_sub * liq_frac, tau_sub * (1.0 - liq_frac),
            jnp.broadcast_to((inp.rl * 1e6)[:, None, :], tau_sub.shape),
            jnp.broadcast_to((inp.ri * 1e6)[:, None, :], tau_sub.shape),
            isccp["boxtau"], isccp["boxptop"])
        l3 = modis_l3_simulator(l2["phase"], l2["ctp"], l2["tau"],
                                l2["size"])
        out["modis"] = {"l2": l2, **l3}

    if cfg.use_vgrid:
        zl_s, zu_s = csat_vgrid_bounds(cfg.nlr, cfg.csat_vgrid)
        regrid = lambda y, log=False: change_vertical_grid(
            y, inp.zle, zl_s, zu_s, log_units=log)

    sr = None
    if cfg.run_lidar:
        lid = lidar_simulator(
            play, inp.ple, inp.t,
            mr[I_LSCLIQ], mr[I_LSCICE],
            jnp.zeros_like(mr[I_LSCLIQ]), jnp.zeros_like(mr[I_LSCLIQ]),
            inp.rl, inp.ri, inp.rl, inp.ri,
            ice_type=cfg.lidar_ice_type)
        if cfg.use_vgrid:
            # statistics on the stat grid (COSP_STATS: regrid beta_tot,
            # betamol and pressure, then run the LMD/IPSL diagnostics)
            pnorm_s = regrid(lid["pnorm"])
            pmol_s = regrid(lid["pmol"][:, None, :])[:, 0]
            pplay_s = regrid(play[:, None, :])[:, 0]
            st = lidar_stats(pnorm_s, pmol_s, lid["refl"],
                             inp.frland, pplay_s)
            # undefined bins (below the model surface / no molecular
            # signal): the reference's sc_ratio = R_UNDEF/R_UNDEF = 1.0
            # is neither cloud (>5) nor attenuated (<=0.01), so such
            # bins are effectively ignored (llnl_stats.F90:62-70);
            # mirror that with an explicit 1.0 sentinel
            sr = jnp.where(pmol_s[:, None, :] > 0.0,
                           pnorm_s / jnp.maximum(pmol_s[:, None, :],
                                                 1e-38), 1.0)
        else:
            st = lidar_stats(lid["pnorm"], lid["pmol"], lid["refl"],
                             inp.frland, play)
            sr = lid["pnorm"] / jnp.maximum(lid["pmol"][:, None, :],
                                            1e-38)
        out["lidar"] = {**lid, **st}

    if cfg.run_radar:
        rh = jnp.clip(inp.qv / jnp.maximum(_qsat(inp.t, play), 1e-12),
                      0.0, 1.0) * 100.0
        zero = jnp.zeros(frac_out.shape, play.dtype)
        hm = jnp.stack([mr.get(i, zero) for i in range(N_HYDRO)]) * 1e3
        re = jnp.stack([re_cld.get(i, zero) for i in range(N_HYDRO)])
        rad = quickbeam_simulator(inp.zle[:, :-1] / 1000.0, play / 100.0,
                                  inp.t - 273.15, rh, hm, re)
        dbze = regrid(rad["dbze"], log=True) if cfg.use_vgrid \
            else rad["dbze"]
        cf = radar_cfad(dbze)
        out["radar"] = {**rad, "cfad_dbze": cf}
        if sr is not None:
            if cfg.use_vgrid:
                # stat-grid profiles are ground-ascending; the
                # first-attenuation scan walks top->surface
                # (llnl_stats.F90:109), so flip, scan, flip back
                freq, tcc = lidar_only_freq_cloud(sr[..., ::-1],
                                                  dbze[..., ::-1])
                freq = freq[..., ::-1]
            else:
                freq, tcc = lidar_only_freq_cloud(sr, dbze)
            out["radar"]["lidar_only_freq_cloud"] = freq
            out["radar"]["radar_lidar_tcc"] = tcc

    return out


def _qsat(t, p_pa):
    """Saturation specific humidity (Magnus over water; replaces
    GEOS_QSAT for the radar RH input)."""
    es = 610.94 * jnp.exp(17.625 * (t - 273.15)
                          / jnp.maximum(t - 30.11, 1.0))
    return 0.622 * es / jnp.maximum(p_pa - 0.378 * es, 1.0)
