"""RRTMG-SW physics tests + cross-scheme validation vs Chou SW."""

import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg.sw import rrtmg_sw
from geosradiation_gridcomp.models.rrtmg.lw import mid_heights
from tests.profiles import make_profile


def run_sw(prof, cosz=0.7, albedo=0.1, scon=1361.0, **kw):
    ncol, nlev = prof["ta"].shape
    ple = prof["ple"]
    play = (0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01).astype(np.float32)
    zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
    o3 = prof["oa"] * (28.966 / 47.9982)
    h2o = prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
    dp = ple[:, 1:] - ple[:, :-1]
    icq = np.where(prof["fcld"] > 0, 1.0 / np.maximum(prof["fcld"], 1e-6), 0.0)
    ciwp = prof["cwc"][..., 0] * dp * 1e3 / 9.80665 * icq
    clwp = prof["cwc"][..., 1] * dp * 1e3 / 9.80665 * icq
    alb = np.full((ncol,), albedo, np.float32)
    return rrtmg_sw(
        ple, play, prof["ta"], np.full((ncol,), cosz, np.float32),
        alb, alb, alb, alb,
        h2o.astype(np.float32), o3.astype(np.float32), prof["co2"],
        prof["ch4"], np.full_like(prof["co2"], 0.2095),
        prof["fcld"], ciwp.astype(np.float32), clwp.astype(np.float32),
        np.full_like(prof["fcld"], 60.0), np.full_like(prof["fcld"], 10.0),
        zm, np.full((ncol,), 0.7, np.float32), 100,
        cloud_mh=prof["ict"], cloud_lm=prof["icb"], scon=scon, **kw)


@pytest.fixture(scope="module")
def clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, run_sw(prof)


@pytest.fixture(scope="module")
def cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, run_sw(prof)


def test_toa_downward_is_insolation(clear):
    _, out = clear
    toa_dn = np.asarray(out["bbfd"][:, 0])
    expect = 1361.0 * 0.7
    np.testing.assert_allclose(toa_dn, expect, rtol=0.01)


def test_energy_conservation(clear):
    _, out = clear
    # absorbed + reflected + surface net = TOA downward
    toa_net = np.asarray(out["bbfd"][:, 0] - out["bbfu"][:, 0])
    sfc_net = np.asarray(out["bbfd"][:, -1] - out["bbfu"][:, -1])
    atm_abs = toa_net - sfc_net
    assert np.all(atm_abs > 0), "atmosphere must absorb SW"
    assert np.all(atm_abs < 0.35 * np.asarray(out["bbfd"][:, 0])), \
        "absorption fraction unphysically large"


def test_clear_equals_allsky_without_clouds(clear):
    _, out = clear
    np.testing.assert_allclose(out["bbfd"], out["bbcd"], rtol=1e-5, atol=0.05)
    np.testing.assert_allclose(out["bbfu"], out["bbcu"], rtol=1e-5, atol=0.05)


def test_direct_less_than_total_down(clear):
    _, out = clear
    assert np.all(np.asarray(out["bbfddir"])
                  <= np.asarray(out["bbfd"]) + 1e-3)


def test_uv_plus_nir_equals_total(clear):
    _, out = clear
    tot = np.asarray(out["uvfd"] + out["nifd"])
    np.testing.assert_allclose(tot, np.asarray(out["bbfd"]), rtol=1e-4)


def test_surface_band_parts_consistent(clear):
    _, out = clear
    # nir + par + uv direct at surface ~ total direct at surface
    parts = np.asarray(out["nirr"] + out["parr"] + out["uvrr"])
    np.testing.assert_allclose(parts, np.asarray(out["bbfddir"][:, -1]),
                               rtol=1e-4)


def test_clouds_brighten_toa(cloudy):
    _, out = cloudy
    assert np.all(np.asarray(out["bbfu"][:, 0])
                  > np.asarray(out["bbcu"][:, 0]) + 1.0)
    assert np.all(np.asarray(out["bbfd"][:, -1])
                  < np.asarray(out["bbcd"][:, -1]) - 1.0)


def test_night_columns_zero(clear):
    prof, _ = clear
    out = run_sw(prof, cosz=-0.2)
    assert np.all(np.asarray(out["bbfd"]) == 0.0)
    assert np.all(np.asarray(out["bbfu"]) == 0.0)


def test_cross_scheme_chou_vs_rrtmg_clear():
    """Independent SW schemes agree on clear-sky broadband fluxes."""
    from geosradiation_gridcomp.models.chou_sw import chou_sw
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    cosz, alb = 0.7, 0.1
    out_r = run_sw(prof, cosz=cosz, albedo=alb)
    albv = np.full((4,), alb, np.float32)
    out_c = chou_sw(
        np.full((4,), cosz, np.float32), prof["ple"], prof["ta"],
        prof["wa"], prof["oa"], prof["co2"], prof["cwc"], prof["fcld"],
        prof["reff"], rsuvbm=albv, rsuvdf=albv, rsirbm=albv, rsirdf=albv,
        ict=prof["ict"], icb=prof["icb"])
    s0 = 1361.0 * cosz
    # net surface SW
    sfc_r = np.asarray(out_r["bbfd"][:, -1] - out_r["bbfu"][:, -1])
    sfc_c = np.asarray(out_c["flx"][:, -1]) * s0
    assert np.all(np.abs(sfc_r - sfc_c) < 0.05 * s0), (sfc_r, sfc_c)
    # TOA upward (planetary albedo)
    up_r = np.asarray(out_r["bbfu"][:, 0])
    up_c = np.asarray(out_c["flxu"][:, 0]) * s0
    assert np.all(np.abs(up_r - up_c) < 0.04 * s0), (up_r, up_c)


def test_daylight_packing_nlit_identical():
    """rrtmg_sw with the static lit-column bound (nlit) must reproduce
    the full computation exactly: identical fluxes on lit columns,
    exact zeros on night columns (PackIt/UnPackIt contract,
    GEOS_SolarGridComp.F90:7753-7799). Mixed scene: some night columns,
    some clear-day, some cloudy-day, nlit > true lit count to cover
    partially-night slices."""
    prof = make_profile(ncol=8, nlev=72, cloudy=True)
    # mixed day/night: columns 2, 5 at night; 3 clear
    cosz = np.full((8,), 0.6, np.float32)
    cosz[2] = -0.1
    cosz[5] = 0.0
    prof = dict(prof)
    prof["fcld"] = np.array(prof["fcld"])
    prof["fcld"][3] = 0.0

    def run(**kw):
        ncol, nlev = prof["ta"].shape
        ple = prof["ple"]
        play = (0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01).astype(np.float32)
        zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
        o3 = prof["oa"] * (28.966 / 47.9982)
        h2o = prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
        dp = ple[:, 1:] - ple[:, :-1]
        icq = np.where(prof["fcld"] > 0,
                       1.0 / np.maximum(prof["fcld"], 1e-6), 0.0)
        ciwp = prof["cwc"][..., 0] * dp * 1e3 / 9.80665 * icq
        clwp = prof["cwc"][..., 1] * dp * 1e3 / 9.80665 * icq
        alb = np.full((ncol,), 0.15, np.float32)
        return rrtmg_sw(
            ple, play, prof["ta"], cosz, alb, alb, alb, alb,
            h2o.astype(np.float32), o3.astype(np.float32), prof["co2"],
            prof["ch4"], np.full_like(prof["co2"], 0.2095),
            prof["fcld"], ciwp.astype(np.float32),
            clwp.astype(np.float32),
            np.full_like(prof["fcld"], 60.0),
            np.full_like(prof["fcld"], 10.0),
            zm, np.full((ncol,), 0.7, np.float32), 100,
            cloud_mh=prof["ict"], cloud_lm=prof["icb"], **kw)

    full = run()
    packed = run(nlit=7)        # true lit count is 6; bound has slack
    # clear/cloudy solver split on top of packing: 5 cloudy-lit columns
    # (3 is clear, 2/5 are night), bound with slack; and the split
    # alone (no packing: all 7 cloudy columns incl. night sort first)
    packed_cld = run(nlit=7, ncld=6)
    split_only = run(ncld=7)
    for k in full:
        if k == "clear_counts":
            # night columns read fully clear under packing (SW cloud
            # diagnostics are daytime-only, as in the reference)
            np.testing.assert_array_equal(
                np.asarray(packed[k])[[0, 1, 3, 4, 6, 7]],
                np.asarray(full[k])[[0, 1, 3, 4, 6, 7]])
            np.testing.assert_array_equal(
                np.asarray(packed_cld[k])[[0, 1, 3, 4, 6, 7]],
                np.asarray(full[k])[[0, 1, 3, 4, 6, 7]])
            np.testing.assert_array_equal(np.asarray(split_only[k]),
                                          np.asarray(full[k]))
            continue
        np.testing.assert_allclose(np.asarray(packed[k]),
                                   np.asarray(full[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        assert not np.asarray(packed[k])[[2, 5]].any(), k
        # the cloudy pass on a clear column IS the clear pass, so the
        # ncld split must be exact (same math, same shapes per column)
        np.testing.assert_allclose(np.asarray(packed_cld[k]),
                                   np.asarray(full[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(np.asarray(split_only[k]),
                                   np.asarray(full[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
