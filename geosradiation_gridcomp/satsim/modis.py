"""MODIS cloud-retrieval simulator (L2 pixel + L3 gridbox aggregation).

Re-derivation of the reference's modis_simulator.F90 (modis_L2_simulator_
twoTaus :147+, modis_L3_simulator :385+, optics fits from Steve Platnick,
two-stream + adding-doubling NIR reflectance). Changes:
  * the serial "integrate to tau limit" loops (cloud_top_pressure,
    weight_by_extinction) become closed-form cumulative-sum expressions
    with a per-layer effective optical-depth clip;
  * the per-layer adding-doubling recursion is a lax.scan;
  * the re retrieval evaluates all trial radii at once and does a
    vectorized bracketed linear interpolation to the observed NIR
    reflectance.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

R_UNDEF = -1.0e30
RE_FILL = -999.0

# algorithmic parameters (modis_simulator.F90:55-99)
ICE_DENSITY = 0.93
MIN_TAU = 0.3
CO2_SLICING_PLIMIT = 700.0e2        # Pa
CO2_SLICING_TAULIMIT = 1.0
PHASE_TAULIMIT = 1.0
SIZE_TAULIMIT = 2.0
PHASE_THRESHOLD = 0.7
PHASE_NONE, PHASE_LIQ, PHASE_ICE, PHASE_UNDET = 0, 1, 2, 3
RE_WATER_MIN, RE_WATER_MAX = 4.0, 30.0
RE_ICE_MIN, RE_ICE_MAX = 5.0, 90.0
NUM_TRIAL_RES = 15
TRIAL_RE_W = np.linspace(RE_WATER_MIN, RE_WATER_MAX, NUM_TRIAL_RES)
TRIAL_RE_I = np.linspace(RE_ICE_MIN, RE_ICE_MAX, NUM_TRIAL_RES)

TAU_HIST_EDGES = np.array([MIN_TAU, 1.3, 3.6, 9.4, 23.0, 60.0, 1e30])
PRES_HIST_EDGES = np.array([0., 18000., 31000., 44000., 56000., 68000.,
                            80000., 1e30])
HIGH_P, LOW_P = 440.0e2, 680.0e2


def _g_nir(phase_is_liquid, re):
    """Asymmetry parameter fit, MODIS band 7 (get_g_nir)."""
    if phase_is_liquid:
        re_s = jnp.clip(re, RE_WATER_MIN, None)
        small = 0.8027 + re_s * (-1.0496e-2 + re_s * 1.7071e-3)
        re_b = jnp.clip(re, None, RE_WATER_MAX)
        big = 0.7931 + re_b * (5.3087e-3 + re_b * -7.4995e-5)
        return jnp.where(re < 8.0, small, big)
    re_c = jnp.clip(re, RE_ICE_MIN, RE_ICE_MAX)
    return 0.7432 + re_c * (4.5563e-3 + re_c * -2.8697e-5)


def _ssa_nir(phase_is_liquid, re):
    """Single-scattering albedo fit, MODIS band 7 (get_ssa_nir)."""
    if phase_is_liquid:
        re_c = jnp.clip(re, RE_WATER_MIN, RE_WATER_MAX)
        return 1.0008 + re_c * (-2.5626e-3 + re_c * 1.6024e-5)
    re_c = jnp.clip(re, RE_ICE_MIN, RE_ICE_MAX)
    return 0.9994 + re_c * (-4.5199e-3
                            + re_c * (3.9370e-5 + re_c * -1.5235e-7))


def _two_stream_rt(tau, g, w0):
    """Delta-Eddington two-stream layer (R, T), diffuse beam
    (two_stream, beam=2 branch)."""
    f = g * g
    taup = (1.0 - w0 * f) * tau
    w0p = (1.0 - f) * w0 / jnp.maximum(1.0 - w0 * f, 1e-12)
    gp = (g - f) / jnp.maximum(1.0 - f, 1e-12)
    g1 = (7.0 - w0p * (4.0 + 3.0 * gp)) / 4.0
    g2 = -(1.0 - w0p * (4.0 - 3.0 * gp)) / 4.0
    # conservative limit
    ref_c = g1 * taup / (1.0 + g1 * taup)
    tra_c = 1.0 - ref_c
    rk = jnp.sqrt(jnp.maximum(g1 * g1 - g2 * g2, 1e-12))
    beta = (rk - g1) / (rk + g1)
    e1 = jnp.minimum(rk * taup, 500.0)
    ef1 = jnp.exp(-e1)
    ef2 = jnp.exp(-2.0 * e1)
    den = (rk + g1) * (1.0 - beta * ef2)
    ref_n = g2 * (1.0 - ef2) / den
    tra_n = 2.0 * rk * ef1 / den
    cons = w0 > 0.9999999
    return jnp.where(cons, ref_c, ref_n), jnp.where(cons, tra_c, tra_n)


def _adding_doubling(refl, tran):
    """Total reflectance of stacked layers (adding_doubling); scan over
    the level axis (leading)."""
    def step(carry, rt):
        rc, tc = carry
        r, t = rt
        den = 1.0 - rc * r
        rc2 = rc + r * tc * tc / jnp.maximum(den, 1e-12)
        tc2 = tc * t / jnp.maximum(den, 1e-12)
        return (rc2, tc2), None
    r0 = jnp.zeros_like(refl[0])
    (rtot, _), _ = lax.scan(step, (r0, jnp.ones_like(r0)), (refl, tran))
    return rtot


def _weight_to_tau_limit(dtau, f, tau_limit):
    """Extinction-weighted mean of per-layer f down to tau_limit
    (weight_by_extinction): closed-form with clipped increments."""
    cum_before = jnp.cumsum(dtau, axis=-1) - dtau
    eff = jnp.clip(tau_limit - cum_before, 0.0, dtau)
    tot = jnp.sum(eff, axis=-1)
    return jnp.sum(eff * f, axis=-1) / jnp.maximum(tot, 1e-12)


def _ctp_to_tau_limit(dtau, plev, tau_limit):
    """Extinction-weighted pressure down to tau_limit with linear-in-p
    layers (cloud_top_pressure): trapezoid + partial-step closed form."""
    p_top = plev[..., :-1]
    p_bot = plev[..., 1:]
    cum_before = jnp.cumsum(dtau, axis=-1) - dtau
    eff = jnp.clip(tau_limit - cum_before, 0.0, dtau)
    contrib = p_top * eff + (p_bot - p_top) * eff * eff \
        / (2.0 * jnp.maximum(dtau, 1e-12))
    tot = jnp.sum(eff, axis=-1)
    return jnp.sum(contrib, axis=-1) / jnp.maximum(tot, 1e-12)


def _interpolate_to_min(x, y, yobs):
    """x minimizing |y - yobs| with bracketed linear root interpolation
    (interpolate_to_min); x: [n], y/yobs: [..., n] / [...]."""
    n = y.shape[-1]
    diff = y - yobs[..., None]
    i_min = jnp.argmin(jnp.abs(diff), axis=-1)

    def take(a, i):
        return jnp.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    d_at = take(diff, i_min)
    d_prev = take(diff, jnp.maximum(i_min - 1, 0))
    # bracket on the sign-change side (f:702-710)
    use_prev = (i_min > 0) & ((i_min == n - 1) | (d_prev * d_at < 0.0))
    lo = jnp.where(use_prev, i_min - 1, i_min)
    hi = jnp.clip(lo + 1, 0, n - 1)
    d_lo = take(diff, lo)
    d_hi = take(diff, hi)
    xg = jnp.asarray(x, y.dtype)
    x_lo = xg[lo]
    x_hi = xg[hi]
    root = x_hi - d_hi * (x_hi - x_lo) / jnp.where(
        jnp.abs(d_hi - d_lo) > 1e-30, d_hi - d_lo, 1e-30)
    return jnp.where(d_lo * d_hi < 0.0, root, RE_FILL)


def _retrieve_re(phase, tau, obs_refl):
    """Size retrieval: match two-stream NIR reflectance over trial radii
    (retrieve_re). phase: [..., ] int; tau/obs_refl: [...]."""
    out = jnp.full(tau.shape, RE_FILL, tau.dtype)
    for ph, trial in ((PHASE_LIQ, TRIAL_RE_W), (PHASE_UNDET, TRIAL_RE_W),
                      (PHASE_ICE, TRIAL_RE_I)):
        liq = ph != PHASE_ICE
        g = _g_nir(liq, jnp.asarray(trial, tau.dtype))
        w0 = _ssa_nir(liq, jnp.asarray(trial, tau.dtype))
        pred, _ = _two_stream_rt(tau[..., None], g, w0)
        re = _interpolate_to_min(trial, pred, obs_refl)
        out = jnp.where(phase == ph, re, out)
    return out


@jax.jit
def modis_l2_simulator(temp, play, plev, tau_liq, tau_ice,
                       size_liq, size_ice, isccp_tau, isccp_ctp_mb):
    """MODIS L2 retrievals per subcolumn (modis_L2_simulator_twoTaus).

    Args:
      temp/play: [np, nlev]; plev: [np, nlev+1] (Pa), TOA-first.
      tau_liq/tau_ice: [np, ncol, nlev] layer optical thicknesses.
      size_liq/size_ice: [np, ncol, nlev] particle sizes (micron).
      isccp_tau, isccp_ctp_mb: [np, ncol] from the ISCCP simulator
        (top_height=1); ctp in mb (its boxptop output).

    Returns dict: phase [np, ncol] int, ctp (Pa), tau, size (micron).
    """
    tau_tot = tau_liq + tau_ice
    liq_frac = jnp.where(tau_tot > 0.0,
                         tau_liq / jnp.maximum(tau_tot, 1e-12), 0.0)
    retr_tau = jnp.sum(tau_tot, axis=-1)
    cloudy = retr_tau >= MIN_TAU

    ctp = _ctp_to_tau_limit(tau_tot, plev[:, None, :],
                            CO2_SLICING_TAULIMIT)
    int_liq = _weight_to_tau_limit(tau_tot, liq_frac, PHASE_TAULIMIT)
    phase = jnp.where(
        int_liq >= PHASE_THRESHOLD, PHASE_LIQ,
        jnp.where(int_liq <= 1.0 - PHASE_THRESHOLD, PHASE_ICE,
                  PHASE_UNDET))

    # NIR reflectance of the full column (compute_nir_reflectance)
    g_w = _g_nir(True, size_liq)
    w0_w = _ssa_nir(True, size_liq)
    g_i = _g_nir(False, size_ice)
    w0_i = _ssa_nir(False, size_ice)
    gbar = jnp.where(tau_tot > 0.0,
                     (tau_liq * g_w + tau_ice * g_i)
                     / jnp.maximum(tau_tot, 1e-12), 0.0)
    w0bar = jnp.where(
        tau_tot > 0.0,
        (tau_liq * g_w * w0_w + tau_ice * g_i * w0_i)
        / jnp.maximum(gbar * tau_tot, 1e-12), 0.0)
    r_lay, t_lay = _two_stream_rt(tau_tot, gbar, w0bar)
    clear_lay = tau_tot <= 0.0
    r_lay = jnp.where(clear_lay, 0.0, r_lay)
    t_lay = jnp.where(clear_lay, 1.0, t_lay)
    obs_refl = _adding_doubling(jnp.moveaxis(r_lay, -1, 0),
                                jnp.moveaxis(t_lay, -1, 0))
    size = _retrieve_re(phase, retr_tau, obs_refl) * 1.0e-6
    size = jnp.where((size < 0.0) & (size != R_UNDEF),
                     1.0e-6 * RE_FILL, size)

    # thermal fallback below the CO2-slicing limit: use ISCCP CTP
    ctp = jnp.where(cloudy & (ctp > CO2_SLICING_PLIMIT),
                    isccp_ctp_mb * 100.0, ctp)

    und = jnp.full_like(retr_tau, R_UNDEF)
    return dict(
        phase=jnp.where(cloudy, phase, PHASE_NONE),
        ctp=jnp.where(cloudy, ctp, und),
        tau=jnp.where(cloudy, retr_tau, und),
        size=jnp.where(cloudy, size, und))


@jax.jit
def modis_l3_simulator(phase, ctp, tau, size):
    """Gridbox L3 aggregation (modis_L3_simulator). Inputs [np, ncol]
    from modis_l2_simulator (ctp in Pa, size in m)."""
    np_, ncol = phase.shape
    dtype = tau.dtype
    valid = size > 0.0
    cld = (phase != PHASE_NONE) & valid
    wat = (phase == PHASE_LIQ) & valid
    ice = (phase == PHASE_ICE) & valid

    def cnt(m):
        return m.sum(axis=-1).astype(dtype)

    n_tot, n_wat, n_ice = cnt(cld), cnt(wat), cnt(ice)
    n_high = cnt(cld & (ctp <= HIGH_P))
    n_low = cnt(cld & (ctp > LOW_P))
    n_mid = n_tot - n_high - n_low

    def mean_over(m, x, n):
        return jnp.where(n > 0,
                         jnp.sum(jnp.where(m, x, 0.0), axis=-1)
                         / jnp.maximum(n, 1.0), R_UNDEF)

    log_tau = jnp.log10(jnp.maximum(jnp.abs(tau), 1e-30))
    lwp_conv = 2.0 / 3.0 * 1000.0
    out = dict(
        cf_total=jnp.maximum(n_tot / ncol, 0.0),
        cf_water=jnp.maximum(n_wat / ncol, 0.0),
        cf_ice=jnp.maximum(n_ice / ncol, 0.0),
        cf_high=n_high / ncol, cf_mid=n_mid / ncol, cf_low=n_low / ncol,
        tau_total_mean=mean_over(cld, tau, n_tot),
        tau_water_mean=mean_over(wat, tau, n_wat),
        tau_ice_mean=mean_over(ice, tau, n_ice),
        tau_total_logmean=mean_over(cld, log_tau, n_tot),
        tau_water_logmean=mean_over(wat, log_tau, n_wat),
        tau_ice_logmean=mean_over(ice, log_tau, n_ice),
        size_water_mean=mean_over(wat, size, n_wat),
        size_ice_mean=mean_over(ice, size, n_ice),
        ctp_total_mean=mean_over(cld, ctp, jnp.maximum(n_tot, 1.0)),
        lwp_mean=jnp.where(
            n_wat > 0, lwp_conv * jnp.sum(
                jnp.where(wat, size * tau, 0.0), axis=-1)
            / jnp.maximum(n_wat, 1.0), R_UNDEF),
        iwp_mean=jnp.where(
            n_ice > 0, lwp_conv * ICE_DENSITY * jnp.sum(
                jnp.where(ice, size * tau, 0.0), axis=-1)
            / jnp.maximum(n_ice, 1.0), R_UNDEF))

    # tau x CTP joint histogram, pressure bins high->low in the output
    # (modis_simulator.F90:94-123): 6 tau x 7 pressure
    it = jnp.digitize(tau, jnp.asarray(TAU_HIST_EDGES[1:-1]))       # 0..5
    ip = jnp.digitize(ctp, jnp.asarray(PRES_HIST_EDGES[1:-1]))      # 0..6
    cell = it * 7 + ip
    onehot = cell[..., None] == jnp.arange(42)[None, None, :]
    ok = cld & (tau >= MIN_TAU)
    fq = (jnp.sum(jnp.where(ok[..., None], onehot, False), axis=1)
          / ncol).reshape(np_, 6, 7).astype(dtype)
    out["tau_vs_ctp"] = fq[:, :, ::-1]    # highest pressure first
    return out
