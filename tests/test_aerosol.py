"""Aerosol forcing: nonzero aerosol optics + no-aerosol flux quadruples.

Exercises the path the reference feeds through the AERO bundle callback
(GEOS_SolarGridComp.F90:3113-3200) and the no-aerosol variants
(irrad.F90's 4 up + 4 down flux sets; the second SORADCORE pass,
GEOS_SolarGridComp.F90:3249-3259).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from geosradiation_gridcomp.config import RadiationConfig, Scheme
from geosradiation_gridcomp.driver.radiation import (solar_refresh,
                                                         irrad_refresh)
from geosradiation_gridcomp.driver.diagnostics import UNDEF
from geosradiation_gridcomp.models.chou_lw import chou_lw
from tests.test_driver import make_inputs

NA_CFG = RadiationConfig(outputs=frozenset(
    {"olrb", "tbrb", "band_sfc", "clear_counts", "no_aerosol"}))


def _sw_aero(ncol, nlay, nband, scheme, tau=0.8, ssa=0.9, asy=0.7):
    """A scattering aerosol layer in the lower troposphere.

    Convention differs per scheme (as in the reference): RRTMG takes
    (tau, ssa, asy) plain; Chou sorad takes the products
    (tau, tau*ssa, tau*ssa*g).
    """
    taua = np.zeros((ncol, nlay, nband), np.float32)
    taua[:, int(nlay * 0.75):, :] = tau / (nlay * 0.25)
    ssaa = np.full_like(taua, 0.0)
    ssaa[taua > 0] = ssa
    asya = np.full_like(taua, 0.0)
    asya[taua > 0] = asy
    if scheme == Scheme.CHOU:
        return (jnp.asarray(taua), jnp.asarray(ssaa * taua),
                jnp.asarray(asya * ssaa * taua))
    return jnp.asarray(taua), jnp.asarray(ssaa), jnp.asarray(asya)


@pytest.mark.parametrize("scheme", [Scheme.RRTMG, Scheme.CHOU])
def test_sw_aerosol_dims_surface(scheme):
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=False)
    cfg = dataclasses.replace(NA_CFG, sw_scheme=scheme, lw_scheme=scheme)
    nband = 14 if scheme == Scheme.RRTMG else 8
    nlay = 40
    cosz = jnp.full((4,), 0.6, jnp.float32)
    taua, ssaa, asya = _sw_aero(4, nlay, nband, scheme)
    clean = solar_refresh(inp, cosz, 172.0, cfg, prof["ict"], prof["icb"])
    dirty = solar_refresh(inp, cosz, 172.0, cfg, prof["ict"], prof["icb"],
                          taua=taua, ssaa=ssaa, asya=asya)
    # surface net SW must drop under a scattering aerosol
    sfc_clean = np.asarray(clean.flxn[:, -1])
    sfc_dirty = np.asarray(dirty.flxn[:, -1])
    assert np.all(sfc_dirty < sfc_clean - 1e-4), (sfc_clean, sfc_dirty)
    # the no-aerosol internals of the dirty run must match the clean run
    np.testing.assert_allclose(np.asarray(dirty.flxnan),
                               np.asarray(clean.flxn), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(dirty.flcnan),
                               np.asarray(clean.flcn), rtol=1e-5,
                               atol=1e-6)


def test_sw_no_aerosol_alias_when_clean():
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=True)
    cosz = jnp.full((4,), 0.6, jnp.float32)
    st = solar_refresh(inp, cosz, 172.0, NA_CFG, prof["ict"], prof["icb"])
    np.testing.assert_array_equal(np.asarray(st.flxnan),
                                  np.asarray(st.flxn))


def test_sw_no_aerosol_pruned_is_undef():
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=False)
    cfg = RadiationConfig()          # no "no_aerosol" token
    cosz = jnp.full((4,), 0.6, jnp.float32)
    taua, ssaa, asya = _sw_aero(4, 40, 14, Scheme.RRTMG)
    st = solar_refresh(inp, cosz, 172.0, cfg, prof["ict"], prof["icb"],
                       taua=taua, ssaa=ssaa, asya=asya)
    assert np.all(np.asarray(st.flxnan) >= UNDEF)


def test_lw_aerosol_warms_layer_dims_olr():
    """An absorbing LW aerosol must reduce OLR (greenhouse effect) and
    the no-aerosol internals must match an aerosol-free solve."""
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=False)
    taua = np.zeros((4, 40, 16), np.float32)
    taua[:, 28:36, :] = 0.15
    taua = jnp.asarray(taua)
    clean = irrad_refresh(inp, 172.0, NA_CFG, prof["ict"], prof["icb"])
    dirty = irrad_refresh(inp, 172.0, NA_CFG, prof["ict"], prof["icb"],
                          taua=taua)
    olr_clean = -np.asarray(clean.flx[:, 0])
    olr_dirty = -np.asarray(dirty.flx[:, 0])
    assert np.all(olr_dirty < olr_clean - 0.05), (olr_clean, olr_dirty)
    np.testing.assert_allclose(np.asarray(dirty.flxa),
                               np.asarray(clean.flx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dirty.fla),
                               np.asarray(clean.flc), rtol=1e-5, atol=1e-4)


def test_chou_lw_quadruple_single_solve():
    """The Chou solve emits all four flux sets in one sweep; with
    aerosols present the no-aerosol sets must differ and bracket
    physically (aerosol greenhouse: less outgoing at TOA)."""
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=True)
    ncol, nlay = 4, 40
    taua = np.zeros((ncol, nlay, 10), np.float32)
    taua[:, 30:36, :] = 0.2
    ssaa = 0.3 * taua
    asya = 0.6 * ssaa
    emis10 = jnp.full((ncol, 10), 0.99, jnp.float32)
    out = chou_lw(inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
                  emis10, inp.co2, inp.n2o, inp.ch4,
                  inp.cfc11, inp.cfc12, inp.hcfc22,
                  jnp.stack([inp.qi, inp.ql, inp.qr, inp.qs], axis=-1),
                  inp.fcld,
                  jnp.stack([inp.ri, inp.rl, inp.rr, inp.rs], axis=-1),
                  taua=jnp.asarray(taua), ssaa=jnp.asarray(ssaa),
                  asya=jnp.asarray(asya),
                  ict=prof["ict"], icb=prof["icb"], trace=True,
                  with_aerosol=True)
    # TOA: |up flux| with aerosol < without (absorbing aerosol)
    olr_all = -np.asarray(out["flxu"][:, 0] + out["flxd"][:, 0])
    olr_na = -np.asarray(out["flxau"][:, 0] + out["flxad"][:, 0])
    assert np.all(olr_all < olr_na), (olr_all, olr_na)
    # clear no-aerosol differs from clear
    assert np.max(np.abs(np.asarray(out["flau"] - out["flcu"]))) > 1e-3


def test_lw_no_aerosol_pruned_is_undef():
    prof, inp = make_inputs(ncol=4, nlev=40, cloudy=False)
    cfg = RadiationConfig()
    taua = jnp.asarray(np.full((4, 40, 16), 0.01, np.float32))
    st = irrad_refresh(inp, 172.0, cfg, prof["ict"], prof["icb"],
                       taua=taua)
    assert np.all(np.asarray(st.flxa) >= UNDEF)
