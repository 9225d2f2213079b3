"""CALIPSO 532 nm lidar simulator + PARASOL reflectance + LMD/IPSL stats.

Re-derivations of the reference's actsim/lidar_simulator.F90:25-331 and
actsim/lmd_ipsl_stats.F90 (diag_lidar, COSP_CFAD_SR, COSP_CLDFRAC).
Changes: the subcolumn loop is a batch axis; the serial
from-TOA optical-depth accumulations become cumsums; the scattering-
ratio CFAD and layered cloud fractions are one-hot/masked reductions.

All level arrays here are TOA-first (index 0 = top), unlike the
surface-first COSP internals; the formulas are direction-adjusted.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# lidar constants (lidar_simulator.F90:40-50)
CMOL = 6.2446e-32      # molecular backscatter coefficient @532nm
KB = 1.38e-23
RDIFFM = 0.7           # multiple-scattering correction
QSCAT = 2.0            # particle scattering efficiency
RHOLIQ, RHOICE = 1.0e3, 0.5e3
UNDEF = -1.0e30

# particle lidar-ratio polynomial fits k(re) (lidar_simulator.F90:77-117);
# rows: lsliq, lsice, cvliq, cvice; ice rows depend on ice_type
_POL_LIQ = np.array([2.6980e-8, -3.7701e-6, 1.6594e-4, -0.0024, 0.0626])
_POL_ICE0 = np.array([-1.0176e-8, 1.7615e-6, -1.0480e-4, 0.0019, 0.0460])
_POL_ICE1 = np.array([1.3615e-8, -2.04206e-6, 7.51799e-5, 0.00078213,
                      0.0182131])

# PARASOL look-up tables (parasol, lidar_simulator.F90:268-289)
_PARASOL_TAU = np.array([0., 1., 5., 10., 20., 50., 100.])
_PARASOL_TETAS = np.array([0., 20., 40., 60., 80.])
_RLUMA = np.array([
    [0.03, 0.090886, 0.283965, 0.480587, 0.695235, 0.908229, 1.0],
    [0.03, 0.072185, 0.252596, 0.436401, 0.631352, 0.823924, 0.909013],
    [0.03, 0.058410, 0.224707, 0.367451, 0.509180, 0.648152, 0.709554],
    [0.03, 0.052498, 0.175844, 0.252916, 0.326551, 0.398581, 0.430405],
    [0.03, 0.034730, 0.064488, 0.081667, 0.098215, 0.114411, 0.121567]])
_RLUMB = np.array([
    [0.03, 0.092170, 0.311941, 0.511298, 0.712079, 0.898243, 0.976646],
    [0.03, 0.087082, 0.304293, 0.490879, 0.673565, 0.842026, 0.912966],
    [0.03, 0.083325, 0.285193, 0.430266, 0.563747, 0.685773, 0.737154],
    [0.03, 0.084935, 0.233450, 0.312280, 0.382376, 0.446371, 0.473317],
    [0.03, 0.054157, 0.089911, 0.107854, 0.124127, 0.139004, 0.145269]])

# SR CFAD bin upper bounds (COSP_CFAD_SR srbval, 15 bins)
SR_BINS = 15
S_CLR, S_CLD, S_ATT = 1.2, 5.0, 0.01
SRBVAL = np.array([S_ATT, S_CLR, 3., 5., 7., 10., 15., 20., 25., 30.,
                   40., 50., 60., 80., UNDEF - 1.0])


def _kp(re, pol):
    """Lidar ratio polynomial in re [m] evaluated in microns."""
    r = jnp.clip(re, 0.0, 70.0e-6) * 1e6
    k = pol[0] * r ** 4 + pol[1] * r ** 3 + pol[2] * r ** 2 \
        + pol[3] * r + pol[4]
    return jnp.where(re > 0.0, k, 0.0)


def _layer_signal(beta, tau_lay, tau_above):
    """Layer-mean attenuated backscatter (lidar_simulator.F90:196-225):
    beta * exp(-2 tau_above) * (1 - exp(-2 tau_lay)) / (2 tau_lay)."""
    att = jnp.exp(-2.0 * tau_above)
    lay = jnp.where(tau_lay > 0.0,
                    -jnp.expm1(-2.0 * tau_lay)
                    / (2.0 * jnp.maximum(tau_lay, 1e-30)), 1.0)
    return beta * att * lay


@partial(jax.jit, static_argnames=("ice_type",))
def lidar_simulator(pres, presf, temp, q_lsliq, q_lsice, q_cvliq,
                    q_cvice, ls_radliq, ls_radice, cv_radliq, cv_radice,
                    ice_type=0):
    """532 nm attenuated backscatter per subcolumn + PARASOL reflectance.

    Args (TOA-first):
      pres/temp: [np, nlev]; presf: [np, nlev+1] (Pa).
      q_*: [np, ncol, nlev] subcolumn in-cloud mixing ratios (kg/kg) for
        large-scale/convective liquid/ice.
      *_rad*: [np, nlev] gridbox particle radii (m).
      ice_type: 0 spherical / 1 non-spherical ice fits (static).

    Returns dict: pmol [np, nlev] molecular signal, pnorm [np, ncol,
    nlev] total signal, tautot [np, ncol, nlev] integrated optical
    thickness, refl [np, ncol, 5] PARASOL reflectances.
    """
    pol_ice = _POL_ICE0 if ice_type == 0 else _POL_ICE1
    rhoair = pres / (287.04 * temp)
    dz = (presf[..., 1:] - presf[..., :-1]) / (rhoair * 9.81)

    beta_mol = pres / KB / temp * CMOL
    alpha_mol = 8.0 * np.pi / 3.0 * beta_mol
    tau_mol_lay = alpha_mol * dz
    tau_mol_incl = jnp.cumsum(tau_mol_lay, axis=-1)
    tau_mol_above = tau_mol_incl - tau_mol_lay
    pmol = _layer_signal(beta_mol, tau_mol_lay, tau_mol_above)

    # particulate extinction and lidar-ratio-weighted backscatter
    species = ((q_lsliq, ls_radliq, RHOLIQ, _POL_LIQ),
               (q_lsice, ls_radice, RHOICE, pol_ice),
               (q_cvliq, cv_radliq, RHOLIQ, _POL_LIQ),
               (q_cvice, cv_radice, RHOICE, pol_ice))
    beta_part = 0.0
    alpha_part_tot = 0.0
    tau_liq_col = 0.0
    tau_ice_col = 0.0
    for i, (q, rad, rho, pol) in enumerate(species):
        radc = jnp.clip(rad, 0.0, 70.0e-6)[:, None, :]
        alpha = jnp.where(
            radc > 0.0,
            0.75 * QSCAT * rhoair[:, None, :] * q
            / (rho * jnp.maximum(radc, 1e-12)), 0.0)
        kp = _kp(rad, jnp.asarray(pol))[:, None, :]
        beta_part = beta_part + kp * alpha
        alpha_part_tot = alpha_part_tot + alpha
        tau_sp = jnp.sum(RDIFFM * alpha * dz[:, None, :], axis=-1)
        if i in (0, 2):
            tau_liq_col = tau_liq_col + tau_sp
        else:
            tau_ice_col = tau_ice_col + tau_sp

    tau_part_lay = RDIFFM * alpha_part_tot * dz[:, None, :]
    tau_lay = tau_mol_lay[:, None, :] + tau_part_lay
    tau_incl = jnp.cumsum(tau_lay, axis=-1)
    tau_above = tau_incl - tau_lay
    betatot = beta_mol[:, None, :] + beta_part
    pnorm = _layer_signal(betatot, tau_lay, tau_above)

    refl = parasol(tau_liq_col, tau_ice_col)
    return dict(pmol=pmol, pnorm=pnorm, tautot=tau_incl, refl=refl)


def parasol(tau_liq, tau_ice):
    """PARASOL bidirectional reflectance at 5 solar zenith angles from
    column liquid/ice optical thickness (parasol,
    lidar_simulator.F90:237-331): linear interpolation in the liquid
    (rlumA) and ice (rlumB) lookup tables, weighted by phase fraction."""
    dtype = jnp.asarray(tau_liq).dtype
    tl = jnp.maximum(tau_liq, 0.0)
    ti = jnp.maximum(tau_ice, 0.0)
    tot = tl + ti
    frac_liq = jnp.where(tot > 0.0, tl / jnp.maximum(tot, 1e-30), 1.0)
    tau_s = jnp.minimum(tot, _PARASOL_TAU[-1])

    taug = jnp.asarray(_PARASOL_TAU, dtype)
    i = jnp.clip(jnp.searchsorted(taug, tau_s, side="right") - 1, 0, 5)
    w = (tau_s - taug[i]) / (taug[i + 1] - taug[i])
    ra = jnp.asarray(_RLUMA, dtype)      # [5 angles, 7 taus]
    rb = jnp.asarray(_RLUMB, dtype)
    lum_a = ra.T[i] + w[..., None] * (ra.T[i + 1] - ra.T[i])
    lum_b = rb.T[i] + w[..., None] * (rb.T[i + 1] - rb.T[i])
    r_norm = jnp.asarray(1.0 / np.cos(np.pi / 180.0 * _PARASOL_TETAS),
                         dtype)
    return (frac_liq[..., None] * lum_a
            + (1.0 - frac_liq)[..., None] * lum_b) * r_norm


@jax.jit
def lidar_stats(pnorm, pmol, refl, land, pplay):
    """LMD/IPSL lidar diagnostics (diag_lidar, lmd_ipsl_stats.F90):
    scattering-ratio CFAD, 3-D lidar cloud fraction, low/mid/high/total
    layered cloud cover, land-masked grid PARASOL reflectance.

    Args (TOA-first): pnorm [np, ncol, nlev]; pmol [np, nlev];
    refl [np, ncol, 5]; land [np] (0 ocean / 1 land); pplay [np, nlev].

    Returns dict: cfad_sr [np, 15, nlev], srbval [15], lidarcld
    [np, nlev], cldlayer [np, 4] (low, mid, high, total),
    parasolrefl [np, 5].
    """
    np_, ncol, nlev = pnorm.shape
    dtype = pnorm.dtype
    sr = jnp.where(pmol[:, None, :] > 0.0,
                   pnorm / jnp.maximum(pmol[:, None, :], 1e-38), UNDEF)

    # CFAD of SR (COSP_CFAD_SR): bins (-1, srbval[0]], ... (b[i-1], b[i]]
    edges = jnp.asarray(np.concatenate([[-1.0], SRBVAL]), dtype)
    ib = jnp.clip(jnp.searchsorted(edges, sr, side="left") - 1,
                  0, SR_BINS - 1)
    onehot = (ib[..., None] == jnp.arange(SR_BINS)) \
        & (sr != UNDEF)[..., None]     # exclude stat-grid UNDEF bins
    cfad = jnp.sum(onehot, axis=1).astype(dtype) / ncol   # [np, nlev, 15]
    cfad_sr = jnp.swapaxes(cfad, 1, 2)                    # [np, 15, nlev]

    # cloud masks (COSP_CLDFRAC)
    cldy = sr > S_CLD
    srok = sr > S_ATT
    nsub = srok.sum(axis=1).astype(dtype)                 # [np, nlev]
    lidarcld = jnp.where(nsub > 0.0,
                         cldy.sum(axis=1) / jnp.maximum(nsub, 1.0),
                         UNDEF)

    p = pplay[:, None, :]
    cat = (p >= 680.0e2,                                   # low
           (p >= 440.0e2) & (p < 680.0e2),                 # mid
           p < 440.0e2,                                    # high
           jnp.ones_like(p, bool))                         # total
    layers = []
    for m in cat:
        c = (cldy & m).any(axis=-1).sum(axis=-1).astype(dtype)
        n = (srok & m).any(axis=-1).sum(axis=-1).astype(dtype)
        layers.append(jnp.where(n > 0.0, c / jnp.maximum(n, 1.0), UNDEF))
    cldlayer = jnp.stack(layers, axis=-1)

    ocean = jnp.maximum(1.0 - land, 0.0)
    prefl = refl.mean(axis=1) * ocean[:, None] \
        + (1.0 - ocean[:, None]) * UNDEF
    return dict(cfad_sr=cfad_sr, srbval=jnp.asarray(SRBVAL, dtype),
                lidarcld=lidarcld, cldlayer=cldlayer, parasolrefl=prefl)
