"""Band brightness temperature + RATS trace-gas forcing diagnostics."""

import numpy as np
import pytest

from geosradiation_gridcomp.driver import diagnostics as dg


def _planck_band_flux(t, wn1_cm, wn2_cm, n=2000):
    """Numerical band integral of pi*B(wn, T) in W/m^2 (wn in cm^-1)."""
    wn = np.linspace(wn1_cm * 100.0, wn2_cm * 100.0, n)
    b = dg._BIGC * wn ** 3 / np.expm1(dg._ALT * wn / t)
    return np.pi * np.trapezoid(b, wn)


def test_brightness_temperature_recovers_blackbody():
    """For a narrow band filled with blackbody radiance at T, the
    narrow-band inversion must recover T to a small fraction of a K."""
    t_true = 280.0
    for ib in [3, 5, 7]:        # narrow-ish mid-IR bands
        f = _planck_band_flux(t_true, dg.LW_WAVENUM1[ib], dg.LW_WAVENUM2[ib])
        olrb = np.zeros((1, 16), np.float32)
        olrb[0, ib] = f
        tbr = np.asarray(dg.band_brightness_temperature(olrb))
        assert abs(tbr[0, ib] - t_true) < 1.5, (ib, tbr[0, ib])


def test_brightness_temperature_undef_for_zero_flux():
    tbr = np.asarray(dg.band_brightness_temperature(np.zeros((2, 16))))
    assert (tbr == dg.UNDEF).all()


def test_brightness_temperature_monotone_in_flux():
    olrb = np.zeros((3, 16), np.float32)
    olrb[:, 4] = [20.0, 40.0, 60.0]
    tbr = np.asarray(dg.band_brightness_temperature(olrb))[:, 4]
    assert tbr[0] < tbr[1] < tbr[2]


@pytest.fixture(scope="module")
def driver_inputs():
    import __graft_entry__ as g
    from geosradiation_gridcomp.config import RadiationConfig
    inp = g._example_inputs(ncol=4, nlev=42)
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    return inp, cfg, ict, icb


def test_rats_co2_forcing_positive_at_toa(driver_inputs):
    """Zeroing CO2 must increase OLR: the net-down flux at TOA with CO2
    removed is more negative, so forcing = F_all - F_zeroed > 0 at TOA
    (the classic greenhouse forcing sign)."""
    from geosradiation_gridcomp.driver.radiation import irrad_refresh
    inp, cfg, ict, icb = driver_inputs
    rats = dg.rats_refresh(inp, 172.0, cfg, ict, icb, gases=("CO2", "CH4"))
    irr = irrad_refresh(inp, 172.0, cfg, ict, icb)
    flx_rat, forcing = dg.rats_update(rats, irr, inp.tsinst)
    f = np.asarray(forcing)
    assert f.shape[0] == 2
    assert (f[0, :, 0] > 0.5).all(), "CO2 TOA forcing should be O(W/m^2)"
    # CH4 forcing under a cloud-masked column is a ~0.1 W/m^2 difference
    # of ~300 W/m^2 f32 fluxes; allow per-column cancellation noise of a
    # few ulps but require the population signal to be clearly positive
    assert (f[1, :, 0] > -0.05).all(), "CH4 TOA forcing should be positive"
    assert f[1, :, 0].mean() > 0.05, "mean CH4 TOA forcing should be positive"
    assert (f[0, :, 0] > f[1, :, 0]).all(), "CO2 forcing exceeds CH4"


def test_rats_ts_advance_matches_refresh_at_zero_delt(driver_inputs):
    from geosradiation_gridcomp.driver.radiation import irrad_refresh
    inp, cfg, ict, icb = driver_inputs
    rats = dg.rats_refresh(inp, 172.0, cfg, ict, icb, gases=("O3",))
    irr = irrad_refresh(inp, 172.0, cfg, ict, icb)
    flx_rat, _ = dg.rats_update(rats, irr, inp.tsinst)
    np.testing.assert_allclose(np.asarray(flx_rat), np.asarray(rats.flx),
                               rtol=0, atol=1e-6)


def test_band_olr_sums_to_total_and_tbr_physical(driver_inputs):
    """Refresh-time band OLR must sum to total OLR; per-band brightness
    temperatures must be physical for an Earth-like column."""
    from geosradiation_gridcomp.driver.radiation import (irrad_refresh,
                                                             irrad_update)
    inp, cfg, ict, icb = driver_inputs
    irr = irrad_refresh(inp, 172.0, cfg, ict, icb)
    out = irrad_update(irr, inp.tsinst)
    olrb = np.asarray(out["olrb"])
    olr = np.asarray(out["olr"])
    np.testing.assert_allclose(olrb.sum(-1), olr, rtol=2e-3)
    tbr = np.asarray(out["tbrb"])
    assert ((tbr > 150.0) & (tbr < 330.0)).all()
