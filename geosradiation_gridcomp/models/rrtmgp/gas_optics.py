"""Native RRTMGP gas-optics engine: generic T/p/eta interpolation.

This is the capability the reference gets from the external RRTMGP
library (ty_gas_optics_rrtmgp%gas_optics, loaded from NetCDF by
load_and_init - GEOS_SolarGridComp.F90:4609-4621,
GEOS_IrradGridComp.F90:2151+; sources assembled by
GEOS_RadiationShared/RRTMGP_cmake/CMakeLists.txt:6-38): an engine that
consumes an ARBITRARY k-distribution coefficient set (any number of
bands/g-points/gases/flavors/minor contributors) and computes optical
depths by trilinear interpolation in (temperature, eta, log-pressure),
plus Planck sources (LW) or solar source + Rayleigh (SW).

Independent re-derivation in JAX: all per-layer index math is
vectorized over [ncol, nlay]; the coefficient fetches are CONTIGUOUS
row gathers over the flattened (temp, eta, press) grid with the g-axis
dense on lanes (the same layout rule as taumol_lw); flavors and minor
contributors are static python loops (they specialize at trace time
from the coefficient metadata).

Data arrives as a plain dict of numpy arrays (schema in
tools/rrtmgp_ingest.py, which converts RRTMGP NetCDF coefficient files;
synthetic sets for testing are built by tests/test_rrtmgp_engine.py).

Schema (np arrays; 0-based gas indices; gas 0 == dry air):
  press_ref [npress] Pa descending; temp_ref [ntemp] K ascending
  press_ref_trop: scalar Pa
  vmr_ref [2, ngas+1, ntemp]  (itropo: 0 lower, 1 upper)
  flavor [nflav, 2] gas indices (1-based into the gas list, 0 = dry)
  gpoint_flavor [2, ngpt] flavor index (1-based) per (itropo, gpt)
  kmajor [ntemp, neta, npress+1, ngpt]
  band_lims_gpt [nbnd, 2] 1-based inclusive; band_lims_wvn [nbnd, 2]
  minor_lower/minor_upper: dicts with
      kminor [ntemp, neta, ngpt_m_total]
      gpt_limits [nmin, 2] (1-based, into the full gpt axis)
      gas_idx [nmin] (1-based gas), scales_with_density [nmin] bool,
      scaling_gas [nmin] (0 none, else 1-based gas),
      scale_by_complement [nmin] bool
  LW: totplnk [npt, nbnd], planck_frac [ntemp, neta, npress+1, ngpt],
      temp_ref_planck [npt]
  SW: solar_src [ngpt], rayl [2, ntemp, neta, ngpt]
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

PA2HPA = 0.01
M_DRY = 0.028964
M_H2O = 0.018016
AVOGAD = 6.02214076e23
GRAV = 9.80665


# ---------------------------------------------------------------------
# column amounts
# ---------------------------------------------------------------------

def column_gas(plev_pa, vmr, h2ovmr):
    """Column amount [molec/cm^2] of a gas with vmr [ncol, nlay].

    RRTMGP molec/cm^2 convention (rte-rrtmgp get_col_dry): moist-air
    molar mass, then divide the total column by (1 + h2ovmr) for the
    dry-air count. A 1013.25 hPa dry column gives ~2.148e25 molec/cm^2
    (pinned by tests/test_rrtmgp_engine.py, cross-checked against
    models/rrtmg/setcoef_lw.py coldry).
    """
    dp = jnp.abs(plev_pa[:, 1:] - plev_pa[:, :-1])
    m_air = (M_DRY + M_H2O * h2ovmr) / (1.0 + h2ovmr)
    col_dry = dp / (GRAV * m_air) * AVOGAD * 1e-4 / (1.0 + h2ovmr)
    return col_dry * vmr, col_dry


# ---------------------------------------------------------------------
# interpolation state
# ---------------------------------------------------------------------

class InterpState:
    """Per-layer interpolation indices/weights (mo_gas_optics_kernels::
    interpolation equivalent), flavors resolved statically."""

    def __init__(self, data, play_pa, tlay, col_gas):
        press_ref = np.asarray(data["press_ref"], np.float64)
        temp_ref = np.asarray(data["temp_ref"], np.float64)
        npress = press_ref.size
        ntemp = temp_ref.size
        self.neta = int(data["kmajor"].shape[1])
        log_p_ref = np.log(press_ref)
        dlogp = float(log_p_ref[1] - log_p_ref[0])       # negative
        dtemp = float(temp_ref[1] - temp_ref[0])

        logp = jnp.log(play_pa)
        jt = jnp.clip(jnp.floor(
            (tlay - temp_ref[0]) / dtemp).astype(jnp.int32), 0,
            ntemp - 2)
        self.ftemp = (tlay - (temp_ref[0] + jt * dtemp)) / dtemp
        self.jtemp = jt                                   # 0-based low
        jp = jnp.clip(jnp.floor(
            (logp - log_p_ref[0]) / dlogp).astype(jnp.int32), 0,
            npress - 2)
        self.fpress = (logp - (log_p_ref[0] + jp * dlogp)) / dlogp
        self.jpress = jp
        self.tropo = play_pa > float(data["press_ref_trop"])  # lower atm
        self.col_gas = col_gas            # [ngas+1][ncol, nlay]
        self.ncol, self.nlay = tlay.shape

        vmr_ref = np.asarray(data["vmr_ref"], np.float64)
        flavor = np.asarray(data["flavor"], np.int64)
        self.nflav = flavor.shape[0]
        # per (flavor, temp-side): eta interpolation state
        self.jeta = []
        self.feta = []
        self.col_mix = []
        for fl in range(self.nflav):
            g1, g2 = int(flavor[fl, 0]), int(flavor[fl, 1])
            jeta_t, feta_t, cmix_t = [], [], []
            for dt in range(2):
                # ratio of reference vmrs at the bracketing temps,
                # tropo-dependent
                r_low = vmr_ref[0, g1] / np.maximum(vmr_ref[0, g2],
                                                    1e-60)
                r_upp = vmr_ref[1, g1] / np.maximum(vmr_ref[1, g2],
                                                    1e-60)
                r_low_j = jnp.asarray(r_low, tlay.dtype)[
                    jnp.clip(self.jtemp + dt, 0, ntemp - 1)]
                r_upp_j = jnp.asarray(r_upp, tlay.dtype)[
                    jnp.clip(self.jtemp + dt, 0, ntemp - 1)]
                ratio = jnp.where(self.tropo, r_low_j, r_upp_j)
                cmix = col_gas[g1] + ratio * col_gas[g2]
                eta = jnp.where(cmix > 2e-60, col_gas[g1]
                                / jnp.maximum(cmix, 1e-60), 0.5)
                loceta = eta * (self.neta - 1)
                je = jnp.minimum(loceta.astype(jnp.int32),
                                 self.neta - 2)
                fe = loceta - je
                jeta_t.append(je)
                feta_t.append(fe)
                cmix_t.append(cmix)
            self.jeta.append(jeta_t)
            self.feta.append(feta_t)
            self.col_mix.append(cmix_t)

    def fminor(self, fl, dt):
        """2-point eta weights scaled by the temp weight."""
        wt = (1.0 - self.ftemp) if dt == 0 else self.ftemp
        fe = self.feta[fl][dt]
        return (1.0 - fe) * wt, fe * wt


def _gather_rows(tab_flat, idx):
    """tab_flat [R, ng]; idx [ncol, nlay] -> [ncol, nlay, ng]."""
    return tab_flat[idx]


def tau_major(data, st: InterpState, dtype):
    """Major-species optical depth, all bands at once.

    kmajor [ntemp, neta, npress+1, ngpt]; press index is jpress for the
    lower atmosphere and jpress+1 above the tropopause (the RRTMGP
    press-axis doubling at the troposphere split).
    """
    kmajor = np.asarray(data["kmajor"])
    ntemp, neta, npp, ngpt = kmajor.shape
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)  # [2, ngpt]
    kflat = jnp.asarray(kmajor.reshape(ntemp * neta * npp, ngpt), dtype)

    p0 = st.jpress + jnp.where(st.tropo, 0, 1)
    tau = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
    # group g-points by (lower-flavor, upper-flavor) pair; usually one
    # flavor pair per band, so the static loop is short
    pairs = {}
    for g in range(ngpt):
        key = (int(gpt_flavor[0, g]) - 1, int(gpt_flavor[1, g]) - 1)
        pairs.setdefault(key, []).append(g)
    for (fl_low, fl_upp), gs in pairs.items():
        sel = np.zeros(ngpt, np.float32)
        sel[gs] = 1.0
        selj = jnp.asarray(sel, dtype)
        acc = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
        for dt in range(2):
            # flavor is tropo-dependent per g-point group
            je_l = st.jeta[fl_low][dt]
            je_u = st.jeta[fl_upp][dt]
            je = jnp.where(st.tropo, je_l, je_u)
            fe = jnp.where(st.tropo, st.feta[fl_low][dt],
                           st.feta[fl_upp][dt])
            cmix = jnp.where(st.tropo, st.col_mix[fl_low][dt],
                             st.col_mix[fl_upp][dt])
            wt = (1.0 - st.ftemp) if dt == 0 else st.ftemp
            base = ((st.jtemp + dt) * neta + je) * npp + p0
            for de in range(2):
                we = (1.0 - fe) if de == 0 else fe
                for dp_ in range(2):
                    wp = (1.0 - st.fpress) if dp_ == 0 else st.fpress
                    k = _gather_rows(kflat, base + de * npp + dp_)
                    acc = acc + (cmix * wt * we * wp)[..., None] * k
        tau = tau + acc * selj
    return tau


def tau_minor(data, st: InterpState, play_pa, tlay, which, dtype):
    """Minor-contributor optical depths (gas_optical_depths_minor)."""
    md = data[which]
    if md is None or md["kminor"].size == 0:
        return 0.0
    kminor = np.asarray(md["kminor"])      # [ntemp, neta, nk_total]
    ntemp, neta, _ = kminor.shape
    gpt_lims = np.asarray(md["gpt_limits"], np.int64)
    gas_idx = np.asarray(md["gas_idx"], np.int64)
    swd = np.asarray(md["scales_with_density"], bool)
    sgas = np.asarray(md["scaling_gas"], np.int64)
    sbc = np.asarray(md["scale_by_complement"], bool)
    ngpt = int(data["kmajor"].shape[-1])
    in_lower = which == "minor_lower"
    mask = st.tropo if in_lower else ~st.tropo

    tau = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
    col_dry = st.col_gas[0]
    h2o = st.col_gas[int(data["h2o_idx"])]
    k0 = 0
    for m in range(gpt_lims.shape[0]):
        g1, g2 = int(gpt_lims[m, 0]) - 1, int(gpt_lims[m, 1])
        nk = g2 - g1
        km = kminor[:, :, k0:k0 + nk]
        k0 += nk
        scaling = st.col_gas[int(gas_idx[m])]
        if swd[m]:
            scaling = scaling * (PA2HPA * play_pa / tlay)
            if int(sgas[m]) != 0:
                dry_fact = 1.0 / (1.0 + h2o / jnp.maximum(col_dry,
                                                          1e-60))
                frac = st.col_gas[int(sgas[m])] \
                    / jnp.maximum(col_dry, 1e-60) * dry_fact
                scaling = scaling * ((1.0 - frac) if sbc[m] else frac)
        # flavor is resolved PER G-POINT (mo_gas_optics_rrtmgp
        # gpoint_flavor): group the contributor's g-points by flavor;
        # standard coefficient sets keep one flavor per minor range, so
        # this static loop is almost always a single iteration
        gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)
        fls = gpt_flavor[0 if in_lower else 1, g1:g2] - 1   # [nk]
        kflat = jnp.asarray(km.reshape(ntemp * neta, nk), dtype)
        acc = jnp.zeros(st.ftemp.shape + (nk,), dtype)
        for fl in np.unique(fls):
            sel = jnp.asarray((fls == fl).astype(np.float32), dtype)
            acc_fl = jnp.zeros(st.ftemp.shape + (nk,), dtype)
            for dt in range(2):
                w0, w1 = st.fminor(int(fl), dt)
                base = (st.jtemp + dt) * neta + st.jeta[int(fl)][dt]
                acc_fl = acc_fl + w0[..., None] * _gather_rows(kflat,
                                                               base) \
                    + w1[..., None] * _gather_rows(kflat, base + 1)
            acc = acc + acc_fl * sel
        contrib = (scaling * mask.astype(dtype))[..., None] * acc
        tau = tau.at[..., g1:g2].add(contrib)
    return tau


def planck_source(data, st: InterpState, tlay, tlev, tsfc, dtype):
    """Planck fractions + band-integrated Planck sources (LW).

    Returns (pfrac [ncol, nlay, ngpt], planklay [ncol, nlay, nbnd],
    planklev [ncol, nlay+1, nbnd], plankbnd [ncol, nbnd],
    dplankbnd_dts [ncol, nbnd]).
    """
    pf = np.asarray(data["planck_frac"])
    ntemp, neta, npp, ngpt = pf.shape
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)
    pflat = jnp.asarray(pf.reshape(ntemp * neta * npp, ngpt), dtype)
    p0 = st.jpress + jnp.where(st.tropo, 0, 1)
    pairs = {}
    for g in range(ngpt):
        key = (int(gpt_flavor[0, g]) - 1, int(gpt_flavor[1, g]) - 1)
        pairs.setdefault(key, []).append(g)
    pfrac = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
    for (fl_low, fl_upp), gs in pairs.items():
        sel = np.zeros(ngpt, np.float32)
        sel[gs] = 1.0
        selj = jnp.asarray(sel, dtype)
        acc = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
        for dt in range(2):
            je = jnp.where(st.tropo, st.jeta[fl_low][dt],
                           st.jeta[fl_upp][dt])
            fe = jnp.where(st.tropo, st.feta[fl_low][dt],
                           st.feta[fl_upp][dt])
            wt = (1.0 - st.ftemp) if dt == 0 else st.ftemp
            base = ((st.jtemp + dt) * neta + je) * npp + p0
            for de in range(2):
                we = (1.0 - fe) if de == 0 else fe
                for dp_ in range(2):
                    wp = (1.0 - st.fpress) if dp_ == 0 else st.fpress
                    k = _gather_rows(pflat, base + de * npp + dp_)
                    acc = acc + (wt * we * wp)[..., None] * k
        pfrac = pfrac + acc * selj

    totplnk = jnp.asarray(np.asarray(data["totplnk"]), dtype)
    tref = np.asarray(data["temp_ref_planck"], np.float64)
    t0, dtp = float(tref[0]), float(tref[1] - tref[0])
    npt = tref.size

    def plint(t):
        idx = jnp.clip(jnp.floor((t - t0) / dtp).astype(jnp.int32), 0,
                       npt - 2)
        f = (t - (t0 + idx * dtp)) / dtp
        lo = totplnk[idx]
        hi = totplnk[idx + 1]
        return lo + f[..., None] * (hi - lo)

    planklay = plint(tlay)
    planklev = plint(tlev)
    plankbnd = plint(tsfc)
    # analytic slope of the active piecewise-linear segment (a one-sided
    # finite difference can straddle two segments near a table node)
    idx_s = jnp.clip(jnp.floor((tsfc - t0) / dtp).astype(jnp.int32), 0,
                     npt - 2)
    dplankbnd_dts = (totplnk[idx_s + 1] - totplnk[idx_s]) / dtp
    return pfrac, planklay, planklev, plankbnd, dplankbnd_dts


def tau_rayleigh(data, st: InterpState, dtype):
    """Rayleigh optical depth (SW): krayl [2, ntemp, neta, ngpt]
    interpolated in (temp, eta), scaled by (col_dry + col_h2o)."""
    krayl = np.asarray(data["rayl"])
    _, ntemp, neta, ngpt = krayl.shape
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)
    taur = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
    scale = st.col_gas[0] + st.col_gas[int(data["h2o_idx"])]
    for itropo in range(2):
        mask = st.tropo if itropo == 0 else ~st.tropo
        kflat = jnp.asarray(
            krayl[itropo].reshape(ntemp * neta, ngpt), dtype)
        pairs = {}
        for g in range(ngpt):
            pairs.setdefault(int(gpt_flavor[itropo, g]) - 1,
                             []).append(g)
        for fl, gs in pairs.items():
            sel = np.zeros(ngpt, np.float32)
            sel[gs] = 1.0
            acc = jnp.zeros((st.ncol, st.nlay, ngpt), dtype)
            for dt in range(2):
                w0, w1 = st.fminor(fl, dt)
                base = (st.jtemp + dt) * neta + st.jeta[fl][dt]
                acc = acc + w0[..., None] * _gather_rows(kflat, base) \
                    + w1[..., None] * _gather_rows(kflat, base + 1)
            taur = taur + (mask.astype(dtype) * scale)[..., None] \
                * acc * jnp.asarray(sel, dtype)
    return taur


# ---------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------

def gas_optics_lw(data, play_pa, tlay, plev_pa, tlev, tsfc, vmrs):
    """Generic LW gas optics from a native coefficient set.

    vmrs: dict gas-name -> [ncol, nlay] vmr; data["gas_names"] orders
    the gas axis (gas 0 is dry air).
    Returns (taug [ncol, nlay, ngpt], sources dict).
    """
    dtype = tlay.dtype
    names = [str(s) for s in data["gas_names"]]
    h2o = vmrs.get("h2o", jnp.zeros_like(tlay))
    col_gas = [None] * (len(names) + 1)
    _, col_dry = column_gas(plev_pa, jnp.ones_like(tlay), h2o)
    col_gas[0] = col_dry
    for i, nm in enumerate(names):
        v = vmrs.get(nm, jnp.zeros_like(tlay))
        col_gas[i + 1] = col_dry * v
    st = InterpState(data, play_pa, tlay, col_gas)
    taug = tau_major(data, st, dtype)
    taug = taug + tau_minor(data, st, play_pa, tlay, "minor_lower",
                            dtype)
    taug = taug + tau_minor(data, st, play_pa, tlay, "minor_upper",
                            dtype)
    pfrac, planklay, planklev, plankbnd, dpl = planck_source(
        data, st, tlay, tlev, tsfc, dtype)
    # precipitable water [cm] for the rtrnmc diffusivity-angle fit
    h2o_idx = int(data["h2o_idx"])
    pwvcm = jnp.sum(col_gas[h2o_idx], axis=-1) \
        * (18.015 / 6.02214076e23)
    sources = dict(pfracs=pfrac, planklay=planklay, planklev=planklev,
                   plankbnd=plankbnd, dplankbnd_dts=dpl, pwvcm=pwvcm)
    return taug, sources


def gas_optics_sw(data, play_pa, tlay, plev_pa, vmrs):
    """Generic SW gas optics: (taug, taur, toa_src [ncol, ngpt])."""
    dtype = tlay.dtype
    names = [str(s) for s in data["gas_names"]]
    h2o = vmrs.get("h2o", jnp.zeros_like(tlay))
    col_gas = [None] * (len(names) + 1)
    _, col_dry = column_gas(plev_pa, jnp.ones_like(tlay), h2o)
    col_gas[0] = col_dry
    for i, nm in enumerate(names):
        v = vmrs.get(nm, jnp.zeros_like(tlay))
        col_gas[i + 1] = col_dry * v
    st = InterpState(data, play_pa, tlay, col_gas)
    taug = tau_major(data, st, dtype)
    taug = taug + tau_minor(data, st, play_pa, tlay, "minor_lower",
                            dtype)
    taug = taug + tau_minor(data, st, play_pa, tlay, "minor_upper",
                            dtype)
    taur = tau_rayleigh(data, st, dtype)
    src = jnp.broadcast_to(jnp.asarray(data["solar_src"], dtype),
                           (st.ncol, taug.shape[-1]))
    return taug, taur, src
