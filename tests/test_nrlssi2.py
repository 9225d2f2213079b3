"""NRLSSI2 solar-variability tests (NRLSSI2.F90 + rrtmg_sw_rad.F90 modes)."""

import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg import nrlssi2 as nr
from geosradiation_gridcomp.models.rrtmg.tables_sw import sw_tables, NG_SW


def test_cycle_tables_match_module_constants():
    """The extracted mgavgcyc/sbavgcyc interior means must reproduce the
    hardcoded Mg_avg/SB_avg (NRLSSI2.F90:122-124)."""
    mg, sb = nr._avgcyc_tables()
    assert mg.shape == (134,)
    assert np.isclose(mg[1:-1].mean(), nr.MG_AVG, rtol=1e-5)
    # SB_avg (909.71) comes from the underlying daily NRLSSI2 data, not
    # the tabulated mean cycle (902.71): ~0.8% apart by construction
    assert np.isclose(sb[1:-1].mean(), nr.SB_AVG, rtol=1e-2)
    # matched endpoints (cycle start == cycle end)
    assert mg[0] == mg[-1] and sb[0] == sb[-1]


def test_interpolate_indices_endpoints_and_monotone_interval():
    mg, sb = nr._avgcyc_tables()
    m0, s0 = nr.interpolate_indices(0.0)
    m1, s1 = nr.interpolate_indices(1.0)
    assert m0 == pytest.approx(float(mg[0]))
    assert s1 == pytest.approx(float(sb[-1]))
    # mid-cycle value lies within table range
    mm, sm = nr.interpolate_indices(0.37)
    assert mg.min() <= mm <= mg.max()
    assert sb.min() <= sm <= sb.max()


def test_amplitude_scaling_unity_at_min_and_indsolvar_at_max():
    ind = (1.4, 0.7)
    at_min = nr.adjust_solcyc_amplitudes(nr.SOLCYCFRAC_MIN, ind)
    at_max = nr.adjust_solcyc_amplitudes(nr.SOLCYCFRAC_MAX, ind)
    assert np.allclose(at_min, 1.0)
    assert np.allclose(at_max, ind)


def test_isolvar2_mean_indices_are_mean_sun():
    """Directly specifying the cycle-mean indices must give svar_f=svar_s=1
    (same weights as isolvar=0)."""
    w2 = nr.solar_source_weights(2, 0.0, indsolvar=(nr.MG_AVG, nr.SB_AVG))
    w0 = nr.solar_source_weights(0, 0.0)
    for a, b in zip(w2, w0):
        assert np.allclose(a, b)


def test_isolvar2_scon_honored_exactly():
    """For isolvar=2 with scon>0, svar_i is set so that
    svar_i*Iint + svar_f*Fint + svar_s*Sint == scon."""
    scon = 1358.0
    w = nr.solar_source_weights(2, scon, indsolvar=(0.1600, 1200.0))
    tsi = w.w_irr[0] * nr.IINT + w.w_fac[0] * nr.FINT + w.w_sns[0] * nr.SINT
    assert tsi == pytest.approx(scon, rel=1e-12)


def test_isolvar1_cycle_mean_tsi_matches_scon():
    """<TSI> over the mean cycle equals the requested scon for isolvar=1
    (svar_i chosen so scon is the cycle average)."""
    scon, ind = 1361.0, (1.3, 0.8)
    fr = (np.arange(1, 133) - 0.5) / 132.0
    tsi = []
    for f in fr:
        w = nr.solar_source_weights(1, scon, solcycfrac=float(f),
                                    indsolvar=ind)
        tsi.append(w.w_irr[0] * nr.IINT + w.w_fac[0] * nr.FINT
                   + w.w_sns[0] * nr.SINT)
    assert np.mean(tsi) == pytest.approx(scon, rel=2e-4)


def test_isolvar_minus1_matches_kurucz_scaling():
    w = nr.solar_source_weights(-1, 1361.0)
    assert np.allclose(w.w_ref, 1361.0 / nr.KURUCZ_SCON)
    assert np.allclose(w.w_fac, 0.0)


def test_nrlssi2_band_integral_matches_mean_tsi():
    """Sum over all 112 g-points of (irradnce + facbrght + snsptdrk) must
    reproduce the NRLSSI2 mean solar constant 1360.85 (Iint+Fint+Sint),
    validating the extracted per-g source tables."""
    t = sw_tables()
    total = 0.0
    for b in range(16, 30):
        tb = t[b]
        s = (np.asarray(tb["irradnce"], np.float64)
             + np.asarray(tb["facbrght"], np.float64)
             + np.asarray(tb["snsptdrk"], np.float64))
        if s.ndim == 2:
            s = s[0]  # eta-dependent: all rows integrate to the band flux
        total += s.sum()
    assert total == pytest.approx(nr.MEAN_TSI, rel=2e-3)


def test_rrtmg_sw_toa_tracks_nrlssi2_tsi():
    """End-to-end: with scon=0, the TOA downward flux equals mu0 times the
    mode's internal TSI - Kurucz 1368.22 for isolvar=-1, and the NRLSSI2
    cycle TSI for isolvar=1 at cycle maximum."""
    from tests.profiles import make_profile
    from tests.test_rrtmg_sw import run_sw

    prof = make_profile(ncol=2, nlev=72, cloudy=False)
    prof["ict"], prof["icb"] = 20, 30
    cosz = 0.7

    out_kur = run_sw(prof, cosz=cosz, scon=0.0, isolvar=-1)
    toa_kur = np.asarray(out_kur["bbfd"][:, 0])
    np.testing.assert_allclose(toa_kur, nr.KURUCZ_SCON * cosz, rtol=0.005)

    f = nr.SOLCYCFRAC_MAX
    out_var = run_sw(prof, cosz=cosz, scon=0.0, isolvar=1, solcycfrac=f)
    mg_now, sb_now = nr.interpolate_indices(f)
    svar_f = (mg_now - nr.MG_0) / (nr.MG_AVG - nr.MG_0)
    svar_s = (sb_now - nr.SB_0) / (nr.SB_AVG - nr.SB_0)
    tsi = nr.IINT + svar_f * nr.FINT + svar_s * nr.SINT
    toa_var = np.asarray(out_var["bbfd"][:, 0])
    np.testing.assert_allclose(toa_var, tsi * cosz, rtol=0.005)
    assert tsi > nr.MEAN_TSI  # cycle max is brighter than the mean sun
