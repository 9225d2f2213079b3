"""Accuracy gate: f64-oracle roundoff bounds + analytic physical limits.

BASELINE.json demands fluxes/heating rates <=1e-5 relative to the Fortran
reference. No Fortran compiler exists in this environment (tests/golden/
is the harness for externally generated data - see test_golden.py), so
this file provides the strongest bounds obtainable internally:

1. f32-vs-f64 self-consistency: the same scheme run in float64 is the
   roundoff oracle; the production f32 path must agree to the level the
   1e-5 Fortran criterion presupposes (if f32 roundoff exceeded it, no
   implementation could pass).
2. Analytic limits with closed-form answers: isothermal opaque LW column
   -> sigma*T^4 (both OLR and surface down), transparent LW -> surface
   emission everywhere with zero down-flux, SW TOA incidence = E0*mu0,
   direct-beam monotonicity, non-negativity, clear<=all-sky consistency.
3. Ts-Jacobian vs finite difference (the Update_Flx linearization,
   GEOS_IrradGridComp.F90:3861-3877).

All schemes run their jnp oracle paths here (CPU backend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg import lw as lwmod
from geosradiation_gridcomp.models.rrtmg.sw import rrtmg_sw
from profiles import make_profile

SIGMA = 5.670374419e-8


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _lw_args(prof, dtype=np.float32, cloudy=False, iso_t=None):
    ple = prof["ple"].astype(dtype)
    ncol, nlevp = ple.shape
    nlev = nlevp - 1
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    play = (pmid * 0.01).astype(dtype)
    ta = prof["ta"].astype(dtype)
    ts = prof["ts"].astype(dtype)
    if iso_t is not None:
        ta = np.full_like(ta, iso_t)
        ts = np.full_like(ts, iso_t)
    tlev = np.asarray(lwmod.level_temperatures(
        jnp.asarray(play), jnp.asarray(ta), jnp.asarray(ple * 0.01),
        jnp.asarray(ts)))
    h2o = (prof["wa"] / (1.0 - prof["wa"]) * (28.964 / 18.015)
           ).astype(dtype)
    o3 = (prof["oa"] * (28.964 / 47.998)).astype(dtype)
    c = lambda v: np.full((ncol, nlev), v, dtype)
    zm = (-7200.0 * np.log(pmid / pmid[:, -1:])).astype(dtype)
    if cloudy:
        fcld = np.zeros((ncol, nlev), dtype)
        fcld[:, 30:40] = 0.6
        ciwp = np.where(fcld > 0, 15.0, 0.0).astype(dtype)
        clwp = np.where(fcld > 0, 25.0, 0.0).astype(dtype)
    else:
        fcld = c(0.0)
        ciwp = c(0.0)
        clwp = c(0.0)
    emis = np.full((ncol, 16), 1.0, dtype)
    alat = np.linspace(-1.2, 1.2, ncol).astype(dtype)
    args = (ple, play, ta, tlev, ts, emis, h2o, o3,
            prof["co2"].astype(dtype), prof["ch4"].astype(dtype),
            prof["n2o"].astype(dtype), c(0.2095), c(0.0),
            prof["cfc11"].astype(dtype), prof["cfc12"].astype(dtype),
            prof["cfc22"].astype(dtype), c(0.0),
            fcld, ciwp, clwp, c(30.0), c(12.0), zm, alat, 172.0)
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def _sw_args(prof, dtype=np.float32, cloudy=False):
    ple = prof["ple"].astype(dtype)
    ncol, nlevp = ple.shape
    nlev = nlevp - 1
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    play = (pmid * 0.01).astype(dtype)
    h2o = (prof["wa"] / (1.0 - prof["wa"]) * (28.964 / 18.015)
           ).astype(dtype)
    o3 = (prof["oa"] * (28.964 / 47.998)).astype(dtype)
    c = lambda v: np.full((ncol, nlev), v, dtype)
    zm = (-7200.0 * np.log(pmid / pmid[:, -1:])).astype(dtype)
    if cloudy:
        fcld = np.zeros((ncol, nlev), dtype)
        fcld[:, 30:40] = 0.6
        ciwp = np.where(fcld > 0, 15.0, 0.0).astype(dtype)
        clwp = np.where(fcld > 0, 25.0, 0.0).astype(dtype)
    else:
        fcld, ciwp, clwp = c(0.0), c(0.0), c(0.0)
    coszen = np.linspace(0.1, 0.95, ncol).astype(dtype)
    alb = lambda v: np.full((ncol,), v, dtype)
    alat = np.linspace(-1.2, 1.2, ncol).astype(dtype)
    args = (ple, play, prof["ta"].astype(dtype), coszen,
            alb(0.1), alb(0.1), alb(0.25), alb(0.25),
            h2o, o3, prof["co2"].astype(dtype),
            prof["ch4"].astype(dtype), c(0.2095),
            fcld, ciwp, clwp, c(30.0), c(12.0), zm, alat, 172.0)
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def _relmax(a, b, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def _heating(uflx, dflx, ple):
    net = np.asarray(dflx) - np.asarray(uflx)
    dp = np.asarray(ple)[:, 1:] - np.asarray(ple)[:, :-1]
    return (net[:, :-1] - net[:, 1:]) / dp


# ---------------------------------------------------------------------
# 1. f32-vs-f64 roundoff oracle
# ---------------------------------------------------------------------

def test_rrtmg_lw_f32_vs_f64(x64):
    """Clear-sky LW: the f32 production path vs the f64 oracle.

    Bound: fluxes 3e-5 relative (100 W/m^2 floor), heating rates 1e-4 -
    the f32 roundoff envelope inside which any Fortran-parity claim must
    live. Clear-sky isolates numerics (no RNG dtype sensitivity).
    """
    prof = make_profile(ncol=4, nlev=72, seed=3)
    o32 = lwmod.rrtmg_lw(*_lw_args(prof, np.float32), cloud_mh=28,
                         cloud_lm=47)
    o64 = lwmod.rrtmg_lw(*_lw_args(prof, np.float64), cloud_mh=28,
                         cloud_lm=47)
    assert o64["uflx"].dtype == jnp.float64
    for k in ("uflx", "dflx", "uflxc", "dflxc"):
        err = _relmax(o32[k], o64[k], 100.0)
        assert err < 3e-5, (k, err)
    # heating rates: the flux-divergence error must stay at flux
    # roundoff (per-Pa rates amplify roundoff unboundedly in the
    # 0.01-Pa-thick top layers, so bound the divergence, then the
    # per-layer relative rate below the 1-Pa line)
    hr32 = _heating(o32["uflx"], o32["dflx"], prof["ple"])
    hr64 = _heating(o64["uflx"], o64["dflx"], prof["ple"])
    dp = prof["ple"][:, 1:] - prof["ple"][:, :-1]
    assert (np.abs(hr32 - hr64) * dp).max() < 3e-5 * 300.0
    deep = dp > 100.0            # resolved (tropo/strato) layers
    rel = np.abs(hr32 - hr64)[deep] / (np.abs(hr64)[deep] + 1e-6)
    assert rel.max() < 2e-4, rel.max()


def test_rrtmg_sw_f32_vs_f64(x64):
    prof = make_profile(ncol=4, nlev=72, seed=4)
    o32 = rrtmg_sw(*_sw_args(prof, np.float32), cloud_mh=28, cloud_lm=47)
    o64 = rrtmg_sw(*_sw_args(prof, np.float64), cloud_mh=28, cloud_lm=47)
    assert o64["bbfd"].dtype == jnp.float64
    for k in ("bbfd", "bbfu", "bbcd", "bbcu", "bbfddir"):
        err = _relmax(o32[k], o64[k], 100.0)
        assert err < 3e-5, (k, err)


def test_chou_lw_f32_vs_f64(x64):
    from geosradiation_gridcomp.models.chou_lw import chou_lw
    prof = make_profile(ncol=4, nlev=72, seed=5)
    ncol, nlev = prof["ta"].shape

    def run(dtype):
        c = lambda v: jnp.full((ncol, nlev), v, dtype)
        cwc = jnp.zeros((ncol, nlev, 4), dtype)
        reff = jnp.full((ncol, nlev, 4), 20.0, dtype)
        emis = jnp.full((ncol, 10), 1.0, dtype)
        return chou_lw(
            jnp.asarray(prof["ple"], dtype), jnp.asarray(prof["ta"], dtype),
            jnp.asarray(prof["wa"], dtype), jnp.asarray(prof["oa"], dtype),
            jnp.asarray(prof["tb"], dtype), jnp.asarray(prof["ts"], dtype),
            emis, jnp.asarray(prof["co2"], dtype),
            jnp.asarray(prof["n2o"], dtype), jnp.asarray(prof["ch4"], dtype),
            jnp.asarray(prof["cfc11"], dtype),
            jnp.asarray(prof["cfc12"], dtype),
            jnp.asarray(prof["cfc22"], dtype),
            cwc, c(0.0), reff, ict=28, icb=47)

    o32 = run(jnp.float32)
    o64 = run(jnp.float64)
    for k in ("flxu", "flxd", "flcu", "flcd"):
        err = _relmax(o32[k], o64[k], 100.0)
        assert err < 5e-5, (k, err)


# ---------------------------------------------------------------------
# 2. Analytic limits
# ---------------------------------------------------------------------

def test_lw_isothermal_opaque_blackbody():
    """Opaque isothermal column at T0 with emis=1: every flux must be
    sigma*T0^4 (to the Planck-table quantization of the scheme)."""
    t0 = 270.0
    prof = make_profile(ncol=2, nlev=72, seed=6)
    args = list(_lw_args(prof, np.float32, iso_t=t0))
    ncol, nlev = np.asarray(args[2]).shape
    fcld = jnp.ones((ncol, nlev), jnp.float32)
    clwp = jnp.full((ncol, nlev), 500.0, jnp.float32)   # very opaque
    args[17], args[18], args[19] = fcld, jnp.zeros_like(clwp), clwp
    out = lwmod.rrtmg_lw(*args, cloud_mh=28, cloud_lm=47)
    bb = SIGMA * t0 ** 4
    olr = np.asarray(out["uflx"])[:, 0]
    dn_sfc = np.asarray(out["dflx"])[:, -1]
    assert np.abs(olr - bb).max() < 0.015 * bb, (olr, bb)
    assert np.abs(dn_sfc - bb).max() < 0.015 * bb, (dn_sfc, bb)
    # isothermal blackbody interior: both faces of every interior layer
    # see sigma*T0^4, so the net flux divergence vanishes (the TOP layer
    # legitimately cools to space - it emits up with nothing above)
    net = np.asarray(out["dflx"]) - np.asarray(out["uflx"])
    div = net[:, 1:-1] - net[:, 2:]          # layers 1..nlev-1, W/m^2
    assert np.abs(div).max() < 0.012 * bb    # ~1%: Planck-table grain


def test_lw_transparent_atmosphere():
    """Near-zero absorbers: up-flux = surface emission at every level,
    down-flux ~ 0 (continuum floors only)."""
    prof = make_profile(ncol=2, nlev=72, seed=7)
    args = list(_lw_args(prof, np.float32))
    ncol, nlev = np.asarray(args[2]).shape
    tiny = jnp.full((ncol, nlev), 1e-12, jnp.float32)
    # h2o, o3, co2, ch4, n2o, o2, co, cfcs, ccl4 all -> ~0
    for i in (6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16):
        args[i] = tiny
    out = lwmod.rrtmg_lw(*args, cloud_mh=28, cloud_lm=47)
    ts = np.asarray(args[4])
    bb = SIGMA * ts ** 4
    uflx = np.asarray(out["uflx"])
    dflx = np.asarray(out["dflx"])
    assert np.abs(uflx - bb[:, None]).max() < 0.02 * bb.max()
    # not exactly zero: the N2-N2 collision continuum scales with
    # coldry, not with any zeroed input gas (band 1); ~25 W/m^2 of the
    # full atmosphere's ~400 remains
    assert dflx.max() < 35.0     # W/m^2


def test_sw_toa_incidence_and_monotonicity():
    """TOA down-flux = E0*mu0; direct beam monotone nonincreasing;
    all fluxes nonnegative; clear-sky direct >= all-sky direct."""
    prof = make_profile(ncol=4, nlev=72, seed=8)
    args = _sw_args(prof, np.float32, cloudy=True)
    out = rrtmg_sw(*args, cloud_mh=28, cloud_lm=47)
    mu0 = np.asarray(args[3])
    toa = np.asarray(out["bbfd"])[:, 0]
    # scon default 1361 with isolvar=-1 folds the internal k-table
    # spectrum to exactly scon
    expect = 1361.0 * mu0
    assert np.abs(toa - expect).max() < 0.005 * expect.max(), (toa, expect)
    ddir = np.asarray(out["bbfddir"])
    assert (np.diff(ddir, axis=1) <= 1e-4).all()
    for k in ("bbfd", "bbfu", "bbcd", "bbcu", "bbfddir", "bbcddir"):
        assert np.asarray(out[k]).min() >= -1e-3, k
    assert (np.asarray(out["bbcddir"]) - ddir >= -1e-3).all()
    # energy: net at TOA >= net at surface >= 0 (absorption in column)
    net = np.asarray(out["bbfd"]) - np.asarray(out["bbfu"])
    assert (net[:, 0] - net[:, -1] >= -1e-3).all()


def test_sw_night_columns_zero():
    prof = make_profile(ncol=4, nlev=72, seed=9)
    args = list(_sw_args(prof, np.float32))
    args[3] = jnp.zeros_like(args[3])       # sun below horizon
    out = rrtmg_sw(*args, cloud_mh=28, cloud_lm=47)
    for k, v in out.items():
        if k == "clear_counts":
            continue
        assert np.abs(np.asarray(v)).max() == 0.0, k


# ---------------------------------------------------------------------
# 3. Ts-Jacobian vs finite difference
# ---------------------------------------------------------------------

def test_lw_ts_jacobian_finite_difference():
    """duflx_dts (the Update_Flx linearization Jacobian) must match the
    finite difference of the scheme under a surface-only Ts perturbation
    (GEOS_IrradGridComp.F90:3861-3877 applies it exactly this way)."""
    prof = make_profile(ncol=2, nlev=72, seed=10)
    args = list(_lw_args(prof, np.float32))
    out0 = lwmod.rrtmg_lw(*args, cloud_mh=28, cloud_lm=47)
    dts = 1.0
    args_p = list(args)
    args_p[4] = args[4] + dts               # tsfc only; tlev fixed
    out1 = lwmod.rrtmg_lw(*args_p, cloud_mh=28, cloud_lm=47)
    fd = (np.asarray(out1["uflx"]) - np.asarray(out0["uflx"])) / dts
    jac = np.asarray(out0["duflx_dts"])
    scale = np.abs(fd).max()
    assert scale > 0.5          # the perturbation must actually matter
    assert np.abs(fd - jac).max() < 0.04 * scale, np.abs(fd - jac).max()
