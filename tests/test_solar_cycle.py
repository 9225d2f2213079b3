"""Solar-cycle file round trip: prep tool -> runtime reader -> isolvar=2."""

import datetime as dt
import subprocess
import sys

import numpy as np

from geosradiation_gridcomp.driver.solar_cycle import (
    SolarCycleData, read_solar_cycle_file)


def _write_sources(tmp_path):
    mg_sb = tmp_path / "model_input.txt"
    rows = []
    day0 = dt.date(2020, 1, 1)
    for i in range(10):
        d = day0 + dt.timedelta(days=i)
        rows.append((d, 0.155 + 1e-4 * i, 900.0 + 10.0 * i,
                     1360.5 + 0.05 * i))
    mg_sb.write_text("# header\n" + "".join(
        f"{d:%Y-%m-%d} {mg:.6f} {sb:.4f}\n" for d, mg, sb, _ in rows))
    tsi = tmp_path / "tsi_daily.csv"
    # drop two days from TSI to exercise the intersection
    tsi.write_text("".join(
        f"{d:%Y%m%d},{t:.3f}\n" for d, _, _, t in rows[:4] + rows[6:]))
    return mg_sb, tsi, rows


def test_prep_and_read_roundtrip(tmp_path):
    mg_sb, tsi, rows = _write_sources(tmp_path)
    out = tmp_path / "NRLSSI2.txt"
    subprocess.run(
        [sys.executable, "tools/nrlssi2_prep.py", "--mg-sb", str(mg_sb),
         "--tsi", str(tsi), "-o", str(out)], check=True)
    data = read_solar_cycle_file(str(out))
    assert len(data.days) == 8          # intersection drops 2 days
    # exact noon readback of the first day
    t, mg, sb = data.at(dt.datetime(2020, 1, 1, 12))
    assert t == np.float64(1360.5) and mg == 0.155 and sb == 900.0


def test_time_interpolation_between_noons():
    days = np.array([dt.date(2021, 6, 1).toordinal(),
                     dt.date(2021, 6, 2).toordinal()])
    d = SolarCycleData(days=days, tsi=np.array([1360.0, 1362.0]),
                       mg=np.array([0.15, 0.16]), sb=np.array([800., 900.]))
    # midnight between the two noons: equal weights
    t, mg, sb = d.at(dt.datetime(2021, 6, 2, 0))
    assert t == 1361.0 and np.isclose(mg, 0.155) and sb == 850.0
    # persistence beyond the series end
    t2, _, _ = d.at(dt.datetime(2021, 7, 1, 12))
    assert t2 == 1362.0
    # persistence before the start
    t3, _, _ = d.at(dt.datetime(2021, 5, 1, 12))
    assert t3 == 1360.0


def test_isolvar2_consumes_file_indices(tmp_path):
    """The Mg/SB from a cycle file drive isolvar=2 weights, with scon
    honored exactly at each time (rrtmg_sw_rad.F90:1090-1101)."""
    from geosradiation_gridcomp.models.rrtmg import nrlssi2 as nr
    days = np.array([dt.date(2021, 6, 1).toordinal()])
    d = SolarCycleData(days=days, tsi=np.array([1359.2]),
                       mg=np.array([0.158]), sb=np.array([1000.0]))
    tsi, mg, sb = d.at_doy(2021, 152.5)
    w = nr.solar_source_weights(2, tsi, indsolvar=(mg, sb))
    got = w.w_irr[0] * nr.IINT + w.w_fac[0] * nr.FINT + w.w_sns[0] * nr.SINT
    assert np.isclose(got, tsi, rtol=1e-12)
