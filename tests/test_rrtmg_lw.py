"""RRTMG-LW physics tests, including cross-scheme validation against the
independent Chou-Suarez LW implementation."""

import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg.lw import (
    rrtmg_lw, level_temperatures, mid_heights)
from tests.profiles import make_profile


def run_lw(prof, cloudy=False, **kw):
    ncol, nlev = prof["ta"].shape
    ple = prof["ple"]
    play = 0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01
    tlev = np.asarray(level_temperatures(play, prof["ta"], ple * 0.01,
                                         prof["ts"]))
    zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
    emis = np.full((ncol, 16), 0.99, np.float32)
    o3 = prof["oa"] * (28.966 / 47.9982)    # mass mixing ratio -> vmr
    h2o = prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
    cldf = prof["fcld"]
    # in-cloud water paths g/m2 from mixing ratios
    dp = ple[:, 1:] - ple[:, :-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        icq = np.where(cldf > 0, 1.0 / np.maximum(cldf, 1e-6), 0.0)
    ciwp = prof["cwc"][..., 0] * dp * 1e3 / 9.80665 * icq
    clwp = prof["cwc"][..., 1] * dp * 1e3 / 9.80665 * icq
    alat = np.full((ncol,), 0.7, np.float32)
    return rrtmg_lw(
        ple, play.astype(np.float32), prof["ta"], tlev, prof["ts"], emis,
        h2o.astype(np.float32), o3.astype(np.float32), prof["co2"],
        prof["ch4"], prof["n2o"],
        np.full_like(prof["co2"], 0.209), np.zeros_like(prof["co2"]),
        prof["cfc11"], prof["cfc12"], prof["cfc22"],
        np.full_like(prof["co2"], 100e-12),
        cldf, ciwp.astype(np.float32), clwp.astype(np.float32),
        np.full_like(cldf, 60.0), np.full_like(cldf, 10.0),
        zm, alat, 100, cloud_mh=prof["ict"], cloud_lm=prof["icb"], **kw)


@pytest.fixture(scope="module")
def clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, run_lw(prof)


@pytest.fixture(scope="module")
def cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, run_lw(prof)


def test_olr_range(clear):
    _, out = clear
    olr = np.asarray(out["uflx"][:, 0])
    assert np.all(olr > 200.0) and np.all(olr < 340.0), olr


def test_toa_downward_zero(clear):
    _, out = clear
    np.testing.assert_allclose(np.asarray(out["dflx"][:, 0]), 0.0, atol=1e-3)


def test_clear_equals_allsky_without_clouds(clear):
    _, out = clear
    np.testing.assert_allclose(out["uflx"], out["uflxc"], rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_allclose(out["dflx"], out["dflxc"], rtol=1e-5,
                               atol=1e-2)


def test_surface_upward_near_blackbody(clear):
    prof, out = clear
    sigma = 5.6704e-8
    up_sfc = np.asarray(out["uflx"][:, -1])
    bb = 0.99 * sigma * prof["ts"] ** 4
    # upward = emission + reflected downward; within ~5%
    np.testing.assert_allclose(up_sfc, bb, rtol=0.05)


def test_duflx_dts_positive(clear):
    _, out = clear
    d = np.asarray(out["duflx_dts"])
    assert np.all(d >= -1e-6)
    # at surface: ~4*eps*sigma*T^3 ~ 5-6 W/m2/K
    assert np.all(d[:, -1] > 3.0) and np.all(d[:, -1] < 8.0), d[:, -1]


def test_band_olr_sums_to_total(clear):
    _, out = clear
    np.testing.assert_allclose(np.asarray(out["olrb"]).sum(axis=1),
                               np.asarray(out["uflx"][:, 0]), rtol=1e-4)


def test_clouds_reduce_olr(cloudy):
    _, out = cloudy
    olr_all = np.asarray(out["uflx"][:, 0])
    olr_clr = np.asarray(out["uflxc"][:, 0])
    assert np.all(olr_all < olr_clr - 1.0)


def test_clouds_increase_surface_down(cloudy):
    _, out = cloudy
    assert np.all(np.asarray(out["dflx"][:, -1])
                  >= np.asarray(out["dflxc"][:, -1]) - 0.1)


def test_clear_counts_consistent(cloudy):
    _, out = cloudy
    counts = np.asarray(out["clear_counts"])
    assert np.all(counts >= 0) and np.all(counts <= 140)
    assert np.all(counts[:, 0] <= counts[:, 1])


def test_cross_scheme_chou_vs_rrtmg_clear():
    """Two independent LW schemes must agree on clear-sky OLR to ~7 W/m2."""
    from geosradiation_gridcomp.models.chou_lw import chou_lw
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    out_r = run_lw(prof)
    emis10 = np.full((4, 10), 0.99, np.float32)
    out_c = chou_lw(
        prof["ple"], prof["ta"], prof["wa"], prof["oa"], prof["tb"],
        prof["ts"], emis10, prof["co2"], prof["n2o"], prof["ch4"],
        prof["cfc11"], prof["cfc12"], prof["cfc22"],
        prof["cwc"], prof["fcld"], prof["reff"],
        ict=prof["ict"], icb=prof["icb"])
    olr_r = np.asarray(out_r["uflx"][:, 0])
    olr_c = -np.asarray(out_c["flxu"][:, 0])
    assert np.all(np.abs(olr_r - olr_c) < 8.0), (olr_r, olr_c)
    dn_r = np.asarray(out_r["dflx"][:, -1])
    dn_c = np.asarray(out_c["flxd"][:, -1])
    assert np.all(np.abs(dn_r - dn_c) < 12.0), (dn_r, dn_c)
