"""Physics sanity tests for the Chou-Suarez SW solver."""

import numpy as np
import pytest

from geosradiation_gridcomp.models.chou_sw import chou_sw
from tests.profiles import make_profile


def run(prof, cosz=0.7, albedo=0.1, **kw):
    ncol, nlev = prof["ta"].shape
    alb = np.full((ncol,), albedo, np.float32)
    return chou_sw(
        np.full((ncol,), cosz, np.float32),
        prof["ple"], prof["ta"], prof["wa"], prof["oa"], prof["co2"],
        prof["cwc"], prof["fcld"], prof["reff"],
        rsuvbm=alb, rsuvdf=alb, rsirbm=alb, rsirdf=alb,
        ict=prof["ict"], icb=prof["icb"], **kw)


@pytest.fixture(scope="module")
def clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, run(prof)


@pytest.fixture(scope="module")
def cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, run(prof)


def test_energy_budget_toa(clear):
    _, out = clear
    # normalized: net(TOA) + up(TOA) should be slightly below 1 (absorption
    # above the model top is small)
    total = np.asarray(out["flx"][:, 0] + out["flxu"][:, 0])
    assert np.all(total > 0.95) and np.all(total <= 1.0 + 1e-5), total


def test_net_flux_monotone_decreasing(clear):
    _, out = clear
    flx = np.asarray(out["flx"])
    assert np.all(np.diff(flx, axis=1) < 1e-5), "net SW flux must decrease downward"


def test_fractions_in_range(clear):
    _, out = clear
    for k in ("flx", "flc", "flxu", "flcu"):
        v = np.asarray(out[k])
        assert np.all(v > -1e-6) and np.all(v < 1.0 + 1e-6), k


def test_surface_direct_diffuse_sum(clear):
    prof, out = clear
    # net surface flux = (1 - albedo) * total downward
    down = np.asarray(out["fdiruv"] + out["fdifuv"] + out["fdirpar"]
                      + out["fdifpar"] + out["fdirir"] + out["fdifir"])
    net_sfc = np.asarray(out["flx"][:, -1])
    np.testing.assert_allclose(net_sfc, 0.9 * down, rtol=0.02)


def test_band_fluxes_sum_to_total(clear):
    _, out = clear
    band_sum = np.asarray(out["flx_sfc_band"]).sum(axis=1)
    np.testing.assert_allclose(band_sum, np.asarray(out["flx"][:, -1]),
                               rtol=0.02)


def test_clear_equals_allsky_without_clouds(clear):
    _, out = clear
    np.testing.assert_allclose(out["flx"], out["flc"], rtol=1e-4, atol=1e-5)


def test_albedo_increases_upward(clear):
    prof, _ = clear
    lo = run(prof, albedo=0.1)
    hi = run(prof, albedo=0.6)
    assert np.all(np.asarray(hi["flxu"][:, 0]) > np.asarray(lo["flxu"][:, 0]))


def test_clouds_brighten_toa_and_dim_surface(cloudy):
    _, out = cloudy
    up_all = np.asarray(out["flxu"][:, 0])
    up_clr = np.asarray(out["flcu"][:, 0])
    assert np.all(up_all > up_clr + 0.005), (up_all, up_clr)
    dn_all = np.asarray(out["flx"][:, -1])
    dn_clr = np.asarray(out["flc"][:, -1])
    assert np.all(dn_all < dn_clr - 0.005)


def test_low_sun_more_attenuation(clear):
    prof, _ = clear
    hi_sun = run(prof, cosz=0.9)
    lo_sun = run(prof, cosz=0.2)
    # transmitted fraction to surface is smaller for low sun
    assert np.all(np.asarray(lo_sun["flx"][:, -1])
                  < np.asarray(hi_sun["flx"][:, -1]))


def test_atmospheric_absorption_fraction(clear):
    _, out = clear
    # atmosphere absorbs ~15-30% of insolation for a moist column
    absorbed = np.asarray(out["flx"][:, 0] - out["flx"][:, -1])
    assert np.all(absorbed > 0.08) and np.all(absorbed < 0.40), absorbed
