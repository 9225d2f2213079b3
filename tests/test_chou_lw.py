"""Physics sanity tests for the Chou-Suarez LW solver."""

import numpy as np
import jax.numpy as jnp
import pytest

from geosradiation_gridcomp.models.chou_lw import chou_lw
from tests.profiles import make_profile


def run(prof, **kw):
    ncol, nlev = prof["ta"].shape
    emis = np.full((ncol, 10), 0.99, np.float32)
    return chou_lw(
        prof["ple"], prof["ta"], prof["wa"], prof["oa"], prof["tb"],
        prof["ts"], emis, prof["co2"], prof["n2o"], prof["ch4"],
        prof["cfc11"], prof["cfc12"], prof["cfc22"],
        prof["cwc"], prof["fcld"], prof["reff"],
        ict=prof["ict"], icb=prof["icb"], **kw)


@pytest.fixture(scope="module")
def clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, run(prof)


@pytest.fixture(scope="module")
def cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, run(prof)


def test_olr_range(clear):
    _, out = clear
    olr = -np.asarray(out["flxu"][:, 0])   # upward flux at TOA (positive W/m2)
    assert np.all(olr > 200.0) and np.all(olr < 340.0), olr


def test_surface_downward_range(clear):
    _, out = clear
    dn_sfc = np.asarray(out["flxd"][:, -1])
    assert np.all(dn_sfc > 200.0) and np.all(dn_sfc < 450.0), dn_sfc


def test_clear_equals_allsky_without_clouds(clear):
    _, out = clear
    np.testing.assert_allclose(out["flxu"], out["flcu"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out["flxd"], out["flcd"], rtol=1e-5, atol=1e-3)


def test_no_aerosol_variant_matches_when_no_aerosols(clear):
    _, out = clear
    np.testing.assert_allclose(out["flxu"], out["flxau"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out["flcd"], out["flad"], rtol=1e-6, atol=1e-4)


def test_downward_toa_zero(clear):
    _, out = clear
    np.testing.assert_allclose(np.asarray(out["flxd"][:, 0]), 0.0, atol=0.3)


def test_sfcem_close_to_emis_sigma_t4(clear):
    prof, out = clear
    sigma = 5.6704e-8
    expect = -0.99 * sigma * prof["ts"] ** 4
    np.testing.assert_allclose(np.asarray(out["sfcem"]), expect, rtol=0.02)


def test_dfdts_negative_at_surface(clear):
    _, out = clear
    # warming the surface raises upward emission -> net flux derivative < 0
    assert np.all(np.asarray(out["dfdts"][:, -1]) < 0.0)


def test_heating_rates_sane(clear):
    prof, out = clear
    net = np.asarray(out["flxu"] + out["flxd"])   # net downward
    dp = prof["ple"][:, 1:] - prof["ple"][:, :-1]
    hr = (net[:, :-1] - net[:, 1:]) * 9.80665 / (1004.16 * dp) * 86400.0
    # below ~1 hPa: LW rates typically within +-12 K/day; mesosphere excluded
    pmid = 0.5 * (prof["ple"][:, 1:] + prof["ple"][:, :-1])
    sel = pmid > 100.0
    assert np.all(hr[sel] > -15.0) and np.all(hr[sel] < 12.0), (
        hr[sel].min(), hr[sel].max())
    # mean tropospheric cooling should be negative
    assert hr[:, -30:].mean() < 0.0


def test_clouds_reduce_olr(cloudy):
    prof, out = cloudy
    olr_all = -np.asarray(out["flxu"][:, 0])
    olr_clr = -np.asarray(out["flcu"][:, 0])
    assert np.all(olr_all < olr_clr - 1.0), (olr_all, olr_clr)


def test_clouds_increase_surface_downward(cloudy):
    _, out = cloudy
    dn_all = np.asarray(out["flxd"][:, -1])
    dn_clr = np.asarray(out["flcd"][:, -1])
    assert np.all(dn_all >= dn_clr - 1e-3)


def test_overcast_matches_fractional_limit(cloudy):
    # fcld=1 clouds: all-sky should differ strongly from clear
    prof = make_profile(ncol=2, nlev=72, cloudy=True)
    prof["fcld"][prof["fcld"] > 0] = 1.0
    out = run(prof)
    olr_all = -np.asarray(out["flxu"][:, 0])
    olr_clr = -np.asarray(out["flcu"][:, 0])
    assert np.all(olr_all < olr_clr - 10.0)


def test_more_co2_warms_surface_net(clear):
    prof, out = clear
    prof2 = dict(prof)
    prof2["co2"] = prof["co2"] * 2.0
    out2 = run(prof2)
    # doubling CO2 reduces OLR (before stratospheric adjustment) by ~1-4 W/m2
    olr1 = -np.asarray(out["flxu"][:, 0])
    olr2 = -np.asarray(out2["flxu"][:, 0])
    assert np.all(olr2 < olr1)
    assert np.all(olr1 - olr2 < 10.0)
