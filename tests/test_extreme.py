"""181-level and extreme-input regression tests.

The reference supports up to 181 levels (seed-spacing note,
GEOS_RadiationShared/cloud_subcol_gen.F90:368-371). These tests run the
full schemes at 181L and under stress inputs (polar night, Ts=190 K,
supersaturated layers, deep thick clouds) on the CPU mesh and assert
finiteness + physical sanity, catching shape assumptions and numeric
blowups that the 72L tests cannot.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg import lw as lwmod
from geosradiation_gridcomp.models.rrtmg.sw import rrtmg_sw
from profiles import make_profile

SIGMA = 5.670374419e-8


def _lw_run(prof, ncol, nlev, **kw):
    ple = prof["ple"]
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    play = (pmid * 0.01).astype(np.float32)
    ta, ts = prof["ta"], prof["ts"]
    tlev = lwmod.level_temperatures(
        jnp.asarray(play), jnp.asarray(ta), jnp.asarray(ple * 0.01),
        jnp.asarray(ts))
    h2o = prof["wa"] / (1.0 - prof["wa"]) * (28.964 / 18.015)
    o3 = prof["oa"] * (28.964 / 47.998)
    c = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
    zm = (-7200.0 * np.log(pmid / pmid[:, -1:])).astype(np.float32)
    emis = jnp.full((ncol, 16), 0.99, jnp.float32)
    alat = jnp.asarray(np.linspace(-1.4, 1.4, ncol), jnp.float32)
    fcld = kw.get("fcld", c(0.0))
    ciwp = kw.get("ciwp", c(0.0))
    clwp = kw.get("clwp", c(0.0))
    return lwmod.rrtmg_lw(
        jnp.asarray(ple), jnp.asarray(play), jnp.asarray(ta), tlev,
        jnp.asarray(ts), emis, jnp.asarray(h2o), jnp.asarray(o3),
        c(4e-4), c(1.8e-6), c(3.2e-7), c(0.2095), c(0.0),
        c(2e-10), c(4e-10), c(1e-10), c(0.0),
        fcld, ciwp, clwp, c(30.0), c(12.0), jnp.asarray(zm), alat,
        172.0, cloud_mh=kw.get("mh", 28), cloud_lm=kw.get("lm", 47))


def _finite(out):
    for k, v in out.items():
        assert bool(jnp.isfinite(v).all()), k


def test_rrtmg_lw_181_levels_allsky():
    ncol, nlev = 2, 181
    prof = make_profile(ncol=ncol, nlev=nlev, seed=11)
    fcld = np.zeros((ncol, nlev), np.float32)
    fcld[:, 80:100] = 0.7
    fcld[:, 150:160] = 0.4
    ciwp = np.where(fcld > 0.5, 12.0, 0.0).astype(np.float32)
    clwp = np.where(fcld > 0, 20.0, 0.0).astype(np.float32)
    out = _lw_run(prof, ncol, nlev, fcld=jnp.asarray(fcld),
                  ciwp=jnp.asarray(ciwp), clwp=jnp.asarray(clwp),
                  mh=70, lm=120)
    _finite(out)
    olr = np.asarray(out["uflx"])[:, 0]
    assert (olr > 120).all() and (olr < 380).all()
    assert out["uflx"].shape == (ncol, nlev + 1)
    # clear counts present and within [0, 140]
    cc = np.asarray(out["clear_counts"])
    assert ((cc >= 0) & (cc <= 140)).all()


def test_rrtmg_sw_181_levels():
    ncol, nlev = 2, 181
    prof = make_profile(ncol=ncol, nlev=nlev, seed=12)
    ple = prof["ple"]
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    play = (pmid * 0.01).astype(np.float32)
    h2o = prof["wa"] / (1.0 - prof["wa"]) * (28.964 / 18.015)
    o3 = prof["oa"] * (28.964 / 47.998)
    c = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
    zm = (-7200.0 * np.log(pmid / pmid[:, -1:])).astype(np.float32)
    fcld = np.zeros((ncol, nlev), np.float32)
    fcld[:, 120:140] = 0.6
    clwp = np.where(fcld > 0, 30.0, 0.0).astype(np.float32)
    alb = lambda v: jnp.full((ncol,), v, jnp.float32)
    out = rrtmg_sw(
        jnp.asarray(ple), jnp.asarray(play), jnp.asarray(prof["ta"]),
        jnp.asarray(np.array([0.3, 0.8], np.float32)),
        alb(0.1), alb(0.1), alb(0.25), alb(0.25),
        jnp.asarray(h2o), jnp.asarray(o3), c(4e-4), c(1.8e-6),
        c(0.2095), jnp.asarray(fcld), c(0.0), jnp.asarray(clwp),
        c(30.0), c(12.0), jnp.asarray(zm),
        jnp.asarray(np.array([0.2, 0.9], np.float32)), 172.0,
        cloud_mh=70, cloud_lm=120)
    _finite(out)
    assert out["bbfd"].shape == (ncol, nlev + 1)
    toa = np.asarray(out["bbfd"])[:, 0]
    assert np.allclose(toa, 1361.0 * np.array([0.3, 0.8]), rtol=0.01)


def test_chou_lw_181_levels():
    from geosradiation_gridcomp.models.chou_lw import chou_lw
    ncol, nlev = 2, 181
    prof = make_profile(ncol=ncol, nlev=nlev, seed=13)
    c = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
    cwc = jnp.zeros((ncol, nlev, 4), jnp.float32)
    cwc = cwc.at[:, 150:160, 1].set(5e-5)
    fcld = jnp.zeros((ncol, nlev), jnp.float32).at[:, 150:160].set(0.5)
    reff = jnp.full((ncol, nlev, 4), 20.0, jnp.float32)
    emis = jnp.full((ncol, 10), 0.99, jnp.float32)
    out = chou_lw(
        jnp.asarray(prof["ple"]), jnp.asarray(prof["ta"]),
        jnp.asarray(prof["wa"]), jnp.asarray(prof["oa"]),
        jnp.asarray(prof["tb"]), jnp.asarray(prof["ts"]),
        emis, c(4e-4), c(3.2e-7), c(1.8e-6),
        c(2e-10), c(4e-10), c(1e-10), cwc, fcld, reff, ict=70, icb=120)
    _finite(out)
    olr = -np.asarray(out["flxu"])[:, 0]
    assert (olr > 120).all() and (olr < 380).all()


def test_lw_polar_night_cold_surface():
    """Ts = 190 K, isothermal-cold column: fluxes finite, OLR below the
    190 K blackbody limit, Jacobian finite and negative-definite in net."""
    ncol, nlev = 2, 72
    prof = make_profile(ncol=ncol, nlev=nlev, seed=14)
    prof["ts"] = np.full(ncol, 190.0, np.float32)
    prof["tb"] = np.full(ncol, 190.5, np.float32)
    prof["ta"] = np.clip(prof["ta"], 185.0, 235.0).astype(np.float32)
    prof["wa"] = np.full_like(prof["wa"], 2e-6)    # bone dry
    out = _lw_run(prof, ncol, nlev)
    _finite(out)
    olr = np.asarray(out["uflx"])[:, 0]
    bb235 = SIGMA * 235.0 ** 4
    assert (olr > 20).all() and (olr < bb235 * 1.05).all()
    assert np.asarray(out["duflx_dts"]).min() >= 0.0   # warmer Ts -> more up


def test_sw_polar_night_zero():
    ncol, nlev = 2, 72
    prof = make_profile(ncol=ncol, nlev=nlev, seed=15)
    ple = prof["ple"]
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    play = (pmid * 0.01).astype(np.float32)
    c = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
    zm = (-7200.0 * np.log(pmid / pmid[:, -1:])).astype(np.float32)
    h2o = prof["wa"] / (1.0 - prof["wa"]) * (28.964 / 18.015)
    alb = lambda v: jnp.full((ncol,), v, jnp.float32)
    out = rrtmg_sw(
        jnp.asarray(ple), jnp.asarray(play), jnp.asarray(prof["ta"]),
        jnp.zeros((ncol,), jnp.float32),
        alb(0.8), alb(0.8), alb(0.8), alb(0.8),
        jnp.asarray(h2o), c(2e-8), c(4e-4), c(1.8e-6), c(0.2095),
        c(0.0), c(0.0), c(0.0), c(30.0), c(12.0), jnp.asarray(zm),
        jnp.full((ncol,), 1.4, jnp.float32), 355.0,
        cloud_mh=28, cloud_lm=47)
    for k, v in out.items():
        if k != "clear_counts":
            assert np.abs(np.asarray(v)).max() == 0.0, k


def test_lw_supersaturated_and_hot():
    """Supersaturated boundary layer (qv 0.08 g/g) over a 340 K surface
    with a deep thick cloud: everything finite, OLR physical."""
    ncol, nlev = 2, 72
    prof = make_profile(ncol=ncol, nlev=nlev, seed=16)
    prof["ts"] = np.full(ncol, 340.0, np.float32)
    prof["ta"] = (prof["ta"] + 25.0).astype(np.float32)
    wa = prof["wa"].copy()
    wa[:, -10:] = 0.08
    prof["wa"] = wa.astype(np.float32)
    fcld = np.zeros((ncol, nlev), np.float32)
    fcld[:, 25:60] = 0.95
    clwp = np.where(fcld > 0, 120.0, 0.0).astype(np.float32)
    ciwp = np.where(fcld > 0, 40.0, 0.0).astype(np.float32)
    out = _lw_run(prof, ncol, nlev, fcld=jnp.asarray(fcld),
                  clwp=jnp.asarray(clwp), ciwp=jnp.asarray(ciwp))
    _finite(out)
    olr = np.asarray(out["uflx"])[:, 0]
    assert (olr > 80).all() and (olr < 600).all()
