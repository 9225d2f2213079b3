"""Radiation driver: intermittent refresh + cheap per-heartbeat updates.

Re-creates the reference's driver semantics in a jit-friendly functional
form (SURVEY.md "Intermittent-physics statefulness"): two compiled
functions per component - an expensive `*_refresh` run on the SOLAR_DT
clock and a cheap `*_update` run every heartbeat - with a host-side clock
deciding which to call. The composite heating-rate synthesis matches
GEOS_RadiationGridComp.F90:798-819.

Input surface (SURVEY.md par. 2.10): the AtmosInputs pytree carries the
SOLAR/IRRAD Import fields; all arrays are column batches, TOA-first.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import RadiationConfig, Scheme
from ..constants import GRAV, CP
from ..models.chou_lw import chou_lw
from ..models.chou_sw import chou_sw
from ..models.rrtmg.lw import rrtmg_lw, level_temperatures, mid_heights
from ..models.rrtmg.spcvmc import MU0_MIN
from ..models.rrtmg.sw import rrtmg_sw
from .state import SolarState, IrradState

_AMD, _AMW, _AMO3 = 28.9660, 18.0160, 47.9982


class AtmosInputs(NamedTuple):
    """Radiation import state (column batch, TOA-first).

    Mirrors the SOLAR/IRRAD Import specs (GEOS_SolarGridComp.F90:490+,
    GEOS_IrradGridComp.F90:254+).
    """
    ple: jnp.ndarray        # [ncol, nlev+1] edge pressure (Pa)
    t: jnp.ndarray          # [ncol, nlev] layer temperature (K)
    qv: jnp.ndarray         # [ncol, nlev] specific humidity (kg/kg)
    ql: jnp.ndarray         # cloud liquid mass fraction
    qi: jnp.ndarray         # cloud ice
    qr: jnp.ndarray         # rain
    qs: jnp.ndarray         # snow
    rl: jnp.ndarray         # effective radii (micron)
    ri: jnp.ndarray
    rr: jnp.ndarray
    rs: jnp.ndarray
    o3: jnp.ndarray         # ozone mass mixing ratio (kg/kg)
    fcld: jnp.ndarray       # cloud fraction
    ch4: jnp.ndarray        # vmr
    n2o: jnp.ndarray
    cfc11: jnp.ndarray
    cfc12: jnp.ndarray
    hcfc22: jnp.ndarray
    co2: jnp.ndarray        # [ncol, nlev] vmr
    ts: jnp.ndarray         # [ncol] skin temperature (refresh average)
    tsinst: jnp.ndarray     # [ncol] instantaneous skin temperature
    t2m: jnp.ndarray        # [ncol] surface air temperature
    emis: jnp.ndarray       # [ncol] broadband surface emissivity
    albvr: jnp.ndarray      # [ncol] visible direct albedo
    albvf: jnp.ndarray      # visible diffuse
    albnr: jnp.ndarray      # NIR direct
    albnf: jnp.ndarray      # NIR diffuse
    lats: jnp.ndarray       # [ncol] radians
    lons: jnp.ndarray       # [ncol] radians


def _undef_cldfrc(ref):
    """UNDEF-filled [ncol, 4] cloud-fraction diagnostic (scheme does not
    produce McICA subcolumn counts, or the output is pruned by config)."""
    from .diagnostics import UNDEF
    return jnp.full((ref.shape[0], 4), UNDEF, ref.dtype)


def _undef_like(x):
    from .diagnostics import UNDEF
    return jnp.full_like(x, UNDEF)


def _cwc_reff(inp):
    cwc = jnp.stack([inp.qi, inp.ql, inp.qr, inp.qs], axis=-1)
    reff = jnp.stack([inp.ri, inp.rl, inp.rr, inp.rs], axis=-1)
    return cwc, reff


def _common_derived(inp):
    play = 0.5 * (inp.ple[..., 1:] + inp.ple[..., :-1]) * 0.01
    h2ovmr = inp.qv * (_AMD / _AMW) / (1.0 - inp.qv)
    o3vmr = inp.o3 * (_AMD / _AMO3)
    return play, h2ovmr, o3vmr


def _incloud_paths(inp):
    """In-cloud water paths (g/m^2) from grid-mean mixing ratios."""
    dp = inp.ple[..., 1:] - inp.ple[..., :-1]
    icq = jnp.where(inp.fcld > 0.0, 1.0 / jnp.maximum(inp.fcld, 1e-6), 0.0)
    ciwp = inp.qi * dp * 1e3 / GRAV * icq
    clwp = inp.ql * dp * 1e3 / GRAV * icq
    return ciwp, clwp


# --------------------------------------------------------------------------
# SOLAR
# --------------------------------------------------------------------------

def solar_refresh(inp: AtmosInputs, cosz, doy, config: RadiationConfig,
                  ict, icb, taua=None, ssaa=None, asya=None,
                  nlit=None, ncld=None) -> SolarState:
    """Full SW RT; stores NORMALIZED internals (fractions of TOA insolation
    at the refresh-time zenith angle). cosz: [ncol] mean cosine over the
    refresh interval (lit part).

    With aerosols present and "no_aerosol" in config.outputs, a second
    aerosol-free pass fills the FSWNAN/FSCNAN/FSWUNAN-equivalent internals
    (the optional no-aerosol SORADCORE pass,
    GEOS_SolarGridComp.F90:3249-3259). Without aerosols the no-aerosol
    internals alias the all-sky ones, as in the reference."""
    st = _solar_refresh_pass(inp, cosz, doy, config, ict, icb,
                             taua, ssaa, asya, nlit, ncld)
    if taua is None:
        return st._replace(flxnan=st.flxn, flcnan=st.flcn,
                           flxunan=st.flxun)
    if config.wants("no_aerosol"):
        na = _solar_refresh_pass(inp, cosz, doy, config, ict, icb,
                                 None, None, None, nlit, ncld)
        return st._replace(flxnan=na.flxn, flcnan=na.flcn,
                           flxunan=na.flxun)
    return st


def _solar_refresh_pass(inp, cosz, doy, config, ict, icb,
                        taua, ssaa, asya, nlit=None,
                        ncld=None) -> SolarState:
    cwc, reff = _cwc_reff(inp)
    play, h2ovmr, o3vmr = _common_derived(inp)

    if config.sw_scheme == Scheme.CHOU:
        out = chou_sw(cosz, inp.ple, inp.t, inp.qv, inp.o3, inp.co2,
                      cwc, inp.fcld, reff,
                      taua=taua, ssaa=ssaa, asya=asya,
                      rsuvbm=inp.albvr, rsuvdf=inp.albvf,
                      rsirbm=inp.albnr, rsirdf=inp.albnf,
                      ict=ict, icb=icb)
        return SolarState(
            flxn=out["flx"], flcn=out["flc"],
            flxun=out["flxu"], flcun=out["flcu"],
            fdir_uv_n=out["fdiruv"], fdif_uv_n=out["fdifuv"],
            fdir_par_n=out["fdirpar"], fdif_par_n=out["fdifpar"],
            fdir_nir_n=out["fdirir"], fdif_nir_n=out["fdifir"],
            flx_sfc_band_n=out["flx_sfc_band"],
            drband_n=out["drband"], dfband_n=out["dfband"],
            cldfrc=_undef_cldfrc(cosz),
            flxnan=_undef_like(out["flx" if "flx" in out else "bbfd"]),
            flcnan=_undef_like(out["flx" if "flx" in out else "bbfd"]),
            flxunan=_undef_like(out["flx" if "flx" in out else "bbfd"]))

    if config.sw_scheme == Scheme.RRTMGP:
        zm = mid_heights(play, inp.t, inp.ple[..., -1])
        ciwp, clwp = _incloud_paths(inp)
        from ..models.rrtmgp.scheme import rrtmgp_sw
        out = rrtmgp_sw(inp.ple, play, inp.t, cosz,
                        inp.albvr, inp.albvf, inp.albnr, inp.albnf,
                        h2ovmr, o3vmr, inp.co2, inp.ch4,
                        jnp.full_like(inp.co2, 0.2095),
                        inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                        zm, inp.lats, doy,
                        taua=taua, ssaa=ssaa, asya=asya,
                        iceflag=config.iceflag_sw,
                        liqflag=config.liqflag_sw,
                        inhm=config.condensate_inhomogeneity,
                        kdist_path=config.rrtmgp_kdist_sw)
        s0 = config.effective_scon() * jnp.maximum(cosz, 1e-6)
        inv = jnp.where(cosz > 0.0, 1.0 / s0, 0.0)
        nv = lambda x: x * inv.reshape((-1,) + (1,) * (x.ndim - 1))
        zc = jnp.zeros_like(cosz)
        # Band-resolved surface diagnostics are not produced by the
        # RRTMGP path (broadband + direct only); requested band outputs
        # are filled with the GEOS missing-data marker (MAPL_UNDEF) so a
        # consumer sees "not available" rather than silent zeros.
        from .diagnostics import UNDEF
        zb = jnp.full(cosz.shape + (14,), UNDEF, out["bbfd"].dtype)
        sfc_dir = nv(out["bbfddir"][:, -1])
        sfc_dif = nv(out["bbfd"][:, -1]) - sfc_dir
        return SolarState(
            flxn=nv(out["bbfd"] - out["bbfu"]),
            flcn=nv(out["bbcd"] - out["bbcu"]),
            flxun=nv(out["bbfu"]), flcun=nv(out["bbcu"]),
            fdir_uv_n=zc, fdif_uv_n=zc,
            fdir_par_n=sfc_dir, fdif_par_n=sfc_dif,
            fdir_nir_n=zc, fdif_nir_n=zc,
            flx_sfc_band_n=zb, drband_n=zb, dfband_n=zb,
            cldfrc=_undef_cldfrc(cosz),
            flxnan=_undef_like(out["flx" if "flx" in out else "bbfd"]),
            flcnan=_undef_like(out["flx" if "flx" in out else "bbfd"]),
            flxunan=_undef_like(out["flx" if "flx" in out else "bbfd"]))

    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)
    out = rrtmg_sw(inp.ple, play, inp.t, cosz,
                   inp.albvr, inp.albvf, inp.albnr, inp.albnf,
                   h2ovmr, o3vmr, inp.co2, inp.ch4,
                   jnp.full_like(inp.co2, 0.2095),
                   inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                   zm, inp.lats, doy,
                   taua=taua, ssaa=ssaa, asya=asya,
                   scon=config.solar_constant,
                   isolvar=config.isolvar,
                   solcycfrac=(config.solcycfrac
                               if config.isolvar == 1 else None),
                   indsolvar=config.indsolvar,
                   iceflag=config.iceflag_sw, liqflag=config.liqflag_sw,
                   cloud_mh=ict, cloud_lm=icb,
                   inhm=config.condensate_inhomogeneity, nlit=nlit,
                   ncld=ncld)
    # normalize by refresh-time TOA insolation, as the solver saw it
    s0 = config.effective_scon() * jnp.maximum(cosz, MU0_MIN)
    inv = jnp.where(cosz > 0.0, 1.0 / s0, 0.0)
    nv = lambda x: x * inv.reshape((-1,) + (1,) * (x.ndim - 1))
    return SolarState(
        flxn=nv(out["bbfd"] - out["bbfu"]), flcn=nv(out["bbcd"] - out["bbcu"]),
        flxun=nv(out["bbfu"]), flcun=nv(out["bbcu"]),
        fdir_uv_n=nv(out["uvrr"]), fdif_uv_n=nv(out["uvrf"] - out["uvrr"]),
        fdir_par_n=nv(out["parr"]), fdif_par_n=nv(out["parf"] - out["parr"]),
        fdir_nir_n=nv(out["nirr"]), fdif_nir_n=nv(out["nirf"] - out["nirr"]),
        flx_sfc_band_n=nv(out["fndsbnd"]),
        drband_n=nv(out["drband"]), dfband_n=nv(out["dfband"]),
        cldfrc=(1.0 - out["clear_counts"].astype(out["bbfd"].dtype) / 112.0
                if config.wants("clear_counts") else _undef_cldfrc(cosz)),
        flxnan=_undef_like(out["bbfd"]), flcnan=_undef_like(out["bbfd"]),
        flxunan=_undef_like(out["bbfd"]))


def solar_update(state: SolarState, cosz_now, doy_now,
                 config: RadiationConfig):
    """Cheap per-heartbeat export: rescale normalized internals by the
    CURRENT TOA insolation (UPDATE_EXPORT, GEOS_SolarGridComp.F90:6676+).

    Returns dict of W/m^2 exports.
    """
    from .astronomy import earth_sun_factor
    from .diagnostics import UNDEF
    sln = (config.effective_scon() * earth_sun_factor(doy_now)
           * jnp.maximum(cosz_now, 0.0))
    scv = lambda x: x * sln.reshape((-1,) + (1,) * (x.ndim - 1))
    # preserve the missing-data marker through the rescale (band
    # diagnostics are UNDEF under schemes that do not produce them)
    sc = lambda x: jnp.where(x >= UNDEF, x, scv(x))
    out = dict(
        fsw=scv(state.flxn), fsc=scv(state.flcn),
        fswu=scv(state.flxun), fscu=scv(state.flcun),
        drpar=sc(state.fdir_par_n), dfpar=sc(state.fdif_par_n),
        druvr=sc(state.fdir_uv_n), dfuvr=sc(state.fdif_uv_n),
        drnir=sc(state.fdir_nir_n), dfnir=sc(state.fdif_nir_n))
    if config.wants("band_sfc"):
        out.update(flx_sfc_band=sc(state.flx_sfc_band_n),
                   drband=sc(state.drband_n), dfband=sc(state.dfband_n))
    if config.wants("no_aerosol"):
        # FSWNA/FSCNA/FSWUNA exports (GEOS_SolarGridComp.F90:2056-2112)
        out.update(fswna=sc(state.flxnan), fscna=sc(state.flcnan),
                   fswuna=sc(state.flxunan))
    return out


# --------------------------------------------------------------------------
# IRRAD
# --------------------------------------------------------------------------

def irrad_refresh(inp: AtmosInputs, doy, config: RadiationConfig,
                  ict, icb, taua=None, ssaa=None, asya=None) -> IrradState:
    """Full LW RT; stores fluxes + dF/dTs Jacobian at refresh time."""
    cwc, reff = _cwc_reff(inp)
    play, h2ovmr, o3vmr = _common_derived(inp)

    if config.lw_scheme == Scheme.CHOU:
        ncol = inp.t.shape[0]
        emis10 = jnp.broadcast_to(inp.emis[:, None], (ncol, 10))
        out = chou_lw(inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
                      emis10, inp.co2, inp.n2o, inp.ch4,
                      inp.cfc11, inp.cfc12, inp.hcfc22,
                      cwc, inp.fcld, reff, taua=taua, ssaa=ssaa, asya=asya,
                      ict=ict, icb=icb, trace=config.trace_gases,
                      with_aerosol=taua is not None)
        # Chou sign: up negative, down positive; net downward = flxd + flxu
        zb = jnp.zeros((ncol, 16), out["flxd"].dtype)
        # the Chou solve emits the no-aerosol variants from the same
        # sweep (irrad.F90's 4 up + 4 down flux sets)
        return IrradState(
            flx=out["flxd"] + out["flxu"], flc=out["flcd"] + out["flcu"],
            flxu=-out["flxu"], flxd=out["flxd"],
            dfdts=out["dfdts"], sfcem=out["sfcem"], ts=inp.tsinst,
            # band OLR is an RRTMG-only diagnostic in the reference
            # (GEOS_IrradGridComp.F90:1257)
            olrb=zb, dolrb_dts=zb,
            flxa=out["flxad"] + out["flxau"],
            fla=out["flad"] + out["flau"],
            # GEOS_IrradGridComp.F90:2105-2109 — "Chou-Suarez does not
            # provide these derivatives": DFDTSC=0, DFDTSNA=DFDTS,
            # DFDTSCNA=DFDTSC(=0)
            dfdtsna=out["dfdts"],
            dfdtscna=jnp.zeros_like(out["dfdts"]))

    if config.lw_scheme == Scheme.RRTMGP:
        ncol = inp.t.shape[0]
        emis16 = jnp.broadcast_to(inp.emis[:, None], (ncol, 16))
        zm = mid_heights(play, inp.t, inp.ple[..., -1])
        ciwp, clwp = _incloud_paths(inp)
        from ..models.rrtmgp.scheme import rrtmgp_lw
        out = rrtmgp_lw(inp.ple, play, inp.t, inp.tsinst, emis16,
                        h2ovmr, o3vmr, inp.co2, inp.ch4, inp.n2o,
                        jnp.full_like(inp.co2, 0.2095),
                        inp.cfc11, inp.cfc12, inp.hcfc22,
                        inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                        zm, inp.lats, doy,
                        iceflag=config.iceflag_lw,
                        liqflag=config.liqflag_lw,
                        inhm=config.condensate_inhomogeneity,
                        dudts=config.ts_derivs,
                        kdist_path=config.rrtmgp_kdist_lw)
        net = out["flux_dn"] - out["flux_up"]
        dfdts = -out["duflx_dts"] if config.ts_derivs \
            else jnp.zeros_like(net)
        sfcem = -(out["flux_up"][:, -1]
                  - out["flux_dn"][:, -1] * (1.0 - inp.emis))
        zb = jnp.zeros((ncol, 16), net.dtype)
        wants_olrb = config.wants("olrb")
        return IrradState(
            flx=net, flc=out["flux_dn_clr"] - out["flux_up_clr"],
            flxu=out["flux_up"], flxd=out["flux_dn"],
            dfdts=dfdts, sfcem=sfcem, ts=inp.tsinst,
            olrb=out["olrb"] if wants_olrb else zb,
            dolrb_dts=(out["dolrb_dts"]
                       if config.ts_derivs and wants_olrb else zb),
            # the RRTMGP LW path takes no aerosol optics; no-aerosol
            # fluxes alias the all-sky ones, and DFDTSCNA aliases the
            # clear-sky derivative (GEOS_IrradGridComp.F90:3127,3556)
            flxa=net, fla=out["flux_dn_clr"] - out["flux_up_clr"],
            dfdtsna=dfdts,
            dfdtscna=(-out["duflxc_dts"] if config.ts_derivs
                      else jnp.zeros_like(net)))

    ncol = inp.t.shape[0]
    emis16 = jnp.broadcast_to(inp.emis[:, None], (ncol, 16))
    tlev = level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)
    out = rrtmg_lw(inp.ple, play, inp.t, tlev, inp.tsinst, emis16,
                   h2ovmr, o3vmr, inp.co2, inp.ch4, inp.n2o,
                   jnp.full_like(inp.co2, 0.2095),
                   jnp.zeros_like(inp.co2),
                   inp.cfc11, inp.cfc12, inp.hcfc22,
                   jnp.full_like(inp.co2, 0.0),
                   inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                   zm, inp.lats, doy, taua=taua,
                   iceflag=config.iceflag_lw, liqflag=config.liqflag_lw,
                   dudts=config.ts_derivs,
                   cloud_mh=ict, cloud_lm=icb,
                   inhm=config.condensate_inhomogeneity)
    net = out["dflx"] - out["uflx"]
    dfdts = -out["duflx_dts"] if config.ts_derivs else jnp.zeros_like(net)
    sfcem = -(out["uflx"][:, -1]
              - out["dflx"][:, -1] * (1.0 - inp.emis))
    zb = jnp.zeros((ncol, 16), net.dtype)
    wants_olrb = config.wants("olrb")
    dfdtsc = (-out["duflxc_dts"] if config.ts_derivs
              else jnp.zeros_like(net))
    if taua is None:
        # aerosol-free run: the no-aerosol quadruple is the quadruple
        flxa, fla, dfdtsna = net, out["dflxc"] - out["uflxc"], dfdts
        dfdtscna = dfdtsc
    elif config.wants("no_aerosol"):
        # second aerosol-free solve (the reference's FLXA/FLA internals
        # come from the RATS-style no-aerosol rerun)
        na = rrtmg_lw(inp.ple, play, inp.t, tlev, inp.tsinst, emis16,
                      h2ovmr, o3vmr, inp.co2, inp.ch4, inp.n2o,
                      jnp.full_like(inp.co2, 0.2095),
                      jnp.zeros_like(inp.co2),
                      inp.cfc11, inp.cfc12, inp.hcfc22,
                      jnp.full_like(inp.co2, 0.0),
                      inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                      zm, inp.lats, doy, taua=None,
                      iceflag=config.iceflag_lw,
                      liqflag=config.liqflag_lw,
                      dudts=config.ts_derivs,
                      cloud_mh=ict, cloud_lm=icb,
                      inhm=config.condensate_inhomogeneity)
        flxa = na["dflx"] - na["uflx"]
        fla = na["dflxc"] - na["uflxc"]
        dfdtsna = -na["duflx_dts"] if config.ts_derivs \
            else jnp.zeros_like(net)
        dfdtscna = -na["duflxc_dts"] if config.ts_derivs \
            else jnp.zeros_like(net)
    else:
        flxa = fla = dfdtsna = dfdtscna = _undef_like(net)
    return IrradState(
        flx=net, flc=out["dflxc"] - out["uflxc"],
        flxu=out["uflx"], flxd=out["dflx"],
        dfdts=dfdts, sfcem=sfcem, ts=inp.tsinst,
        olrb=out["olrb"] if wants_olrb else zb,
        dolrb_dts=(out.get("dolrb_dts", zb)
                   if config.ts_derivs and wants_olrb else zb),
        flxa=flxa, fla=fla, dfdtsna=dfdtsna, dfdtscna=dfdtscna)


def irrad_update(state: IrradState, tsinst, config: RadiationConfig = None):
    """Per-heartbeat Ts-linearized flux advance (Update_Flx,
    GEOS_IrradGridComp.F90:3684-4129): F = F_int + dF/dTs * (Ts - Ts_int).

    Returns dict of W/m^2 exports (net downward convention). Band OLR /
    brightness temperatures are lazy diagnostics: computed only when the
    config's output set requests them (the reference allocates TBRB/OLRB
    exports only when a consumer is connected,
    GEOS_RadiationGridComp.F90:743-785).
    """
    delt = (tsinst - state.ts)[:, None]
    flx = state.flx + state.dfdts * delt
    olr = -(flx[:, 0])
    flns = -(flx[:, -1])
    out = dict(flw=flx, flc=state.flc, olr=olr, flns=flns,
               sfcem=state.sfcem + state.dfdts[:, -1] * delt[:, 0],
               lws=-state.sfcem - state.dfdts[:, -1] * delt[:, 0])
    # Ts-advanced band OLR + brightness temperatures (TBRBbbRG exports,
    # GEOS_IrradGridComp.F90:3994-4017)
    if config is None or config.wants("olrb"):
        out["olrb"] = olrb = state.olrb + state.dolrb_dts * delt
        if config is None or config.wants("tbrb"):
            from .diagnostics import band_brightness_temperature
            out["tbrb"] = band_brightness_temperature(olrb)
    if config is not None and config.wants("no_aerosol"):
        # FLXA advanced by DFDTSNA, FLA by the clear-sky DFDTSCNA
        # (Update_Flx, GEOS_IrradGridComp.F90:3868-3877); UNDEF marker
        # preserved when the internals were pruned
        from .diagnostics import UNDEF
        adv = lambda f, d: jnp.where(f >= UNDEF, f, f + d * delt)
        out.update(flwa=adv(state.flxa, state.dfdtsna),
                   flca_na=adv(state.fla, state.dfdtscna))
    return out


# --------------------------------------------------------------------------
# Composite: heating rates (GEOS_RadiationGridComp.F90:798-819)
# --------------------------------------------------------------------------

def heating_rates(fsw_net, flw_net, ple):
    """DTDT [K/s] from SW+LW net downward flux profiles at levels.

    DTDT = d(F_sw + F_lw)/dp * g/cp with Delta F = F(top) - F(bottom).
    """
    dp = ple[..., 1:] - ple[..., :-1]
    dflux = (fsw_net[..., :-1] - fsw_net[..., 1:]) \
        + (flw_net[..., :-1] - flw_net[..., 1:])
    return dflux * GRAV / (CP * dp)


def surface_lw_linearization(state: IrradState):
    """ALW/BLW exports for the surface energy balance
    (GEOS_RadiationGridComp.F90:798-799): LW_sfc(Ts) ~ ALW + BLW * Ts."""
    dsfdts = -state.dfdts[:, -1]
    alw = state.sfcem - dsfdts * state.ts
    return dict(alw=alw, blw=dsfdts)
