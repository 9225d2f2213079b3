"""Driver-level RRTMGP scheme dispatch (Scheme.RRTMGP end to end)."""

import numpy as np
import pytest

from geosradiation_gridcomp.config import (RadiationConfig, Scheme,
                                               choose_scheme)


def _save_kdist_npz(data, path):
    """Flatten the engine dict to the tools/rrtmgp_ingest.py npz schema
    (minor blocks as minor_{which}_{field} keys)."""
    out = {}
    for k, v in data.items():
        if k in ("minor_lower", "minor_upper"):
            if v:
                for kk, vv in v.items():
                    out[f"{k}_{kk}"] = vv
        else:
            out[k] = v
    np.savez(path, **out)


@pytest.fixture(scope="module")
def kdist_paths(tmp_path_factory):
    from tests.test_rrtmgp_engine import make_kdist
    d = tmp_path_factory.mktemp("kdist")
    data = make_kdist()
    lw, sw = str(d / "lw.npz"), str(d / "sw.npz")
    _save_kdist_npz(data, lw)
    _save_kdist_npz(data, sw)
    return lw, sw


def test_native_kdist_through_driver(kdist_paths):
    """Scheme.RRTMGP + configured coefficient paths routes
    radiation_refresh through the NATIVE engine (KDist*Native +
    rte_*_native) — the reference's real RRTMGP path
    (GEOS_SolarGridComp.F90:4609-4621, GEOS_IrradGridComp.F90:2151+).
    The 2-band synthetic set proves the native engine ran: band
    diagnostics come out with nbnd=2, impossible for the 16-band
    RRTMG-backed facade."""
    import __graft_entry__ as g
    from geosradiation_gridcomp.driver.step import (
        radiation_refresh, radiation_update)
    lw_path, sw_path = kdist_paths
    inp = g._example_inputs(ncol=8, nlev=48)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP,
                          lw_scheme=Scheme.RRTMGP,
                          rrtmgp_kdist_lw=lw_path,
                          rrtmgp_kdist_sw=sw_path,
                          outputs=frozenset({"olrb"}))
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:]
                  + np.asarray(inp.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg, ict=ict,
                                 icb=icb)
    assert irr.olrb.shape == (8, 2)          # native band structure
    assert np.isfinite(np.asarray(irr.flx)).all()
    assert np.isfinite(np.asarray(sol.flxn)).all()
    # LW: TOA upward flux positive, net negative somewhere (cooling)
    assert (np.asarray(irr.flxu)[:, 0] > 0.0).all()
    # Ts Jacobian flows from the native engine (dudts path)
    assert (np.asarray(irr.dfdts)[:, -1] < 0.0).all()
    assert np.any(np.asarray(irr.dfdtscna) != 0.0)
    # SW: normalized fluxes bounded by 1 (net <= TOA insolation)
    assert np.isfinite(np.asarray(sol.flcn)).all()
    assert (np.asarray(sol.flxn) <= 1.0 + 1e-5).all()
    out = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                           inp.ple, 172.0, 12.5, config=cfg)
    assert np.isfinite(np.asarray(out["dtdt"])).all()


def test_band_remap_by_wavenumber():
    from geosradiation_gridcomp.models.rrtmgp.scheme import \
        _band_remap
    host = np.array([[10.0, 350.0], [350.0, 500.0], [500.0, 2000.0]])
    native = np.array([[10.0, 250.0],      # center 130 -> host 0
                       [250.0, 600.0],     # center 425 -> host 1
                       [600.0, 3000.0],    # center 1800 -> host 2
                       [3000.0, 4000.0]])  # outside -> nearest (2)
    np.testing.assert_array_equal(_band_remap(native, host),
                                  [0, 1, 2, 2])


def test_choose_scheme_precedence():
    assert choose_scheme(True, True) == Scheme.RRTMGP
    assert choose_scheme(False, True) == Scheme.RRTMG
    assert choose_scheme() == Scheme.CHOU


def test_full_refresh_with_rrtmgp_scheme():
    import __graft_entry__ as g
    from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                        radiation_update)
    inp = g._example_inputs(ncol=8, nlev=48)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP,
                          lw_scheme=Scheme.RRTMGP)
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg, ict=ict,
                                 icb=icb)
    out = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                           inp.ple, 172.0, 12.5, config=cfg)
    dtdt = np.asarray(out["dtdt"]) * 86400.0
    assert np.isfinite(dtdt).all()
    pmid2 = 0.5 * (np.asarray(inp.ple)[:, 1:] + np.asarray(inp.ple)[:, :-1])
    sel = pmid2 > 10000.0     # troposphere+; thin top layers swing hard
    assert (np.abs(dtdt[sel]) < 40.0).all(), np.abs(dtdt[sel]).max()
    olr = np.asarray(out["lw"]["olr"])
    assert ((olr > 150.0) & (olr < 350.0)).all()


def test_rrtmgp_vs_rrtmg_driver_close():
    """The two schemes share k-tables: driver-level OLR and net SW must
    agree to a few W/m^2 (differences: McICA sampling + solar source)."""
    import __graft_entry__ as g
    from geosradiation_gridcomp.driver.step import radiation_refresh
    inp = g._example_inputs(ncol=8, nlev=48)
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    outs = {}
    for sch in (Scheme.RRTMG, Scheme.RRTMGP):
        cfg = RadiationConfig(sw_scheme=sch, lw_scheme=sch)
        ict, icb = cfg.superlayer_indices(pmid)
        sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                     ict=ict, icb=icb)
        outs[sch] = (np.asarray(sol.flcn), np.asarray(irr.flc))
    sw_g, lw_g = outs[Scheme.RRTMG]
    sw_gp, lw_gp = outs[Scheme.RRTMGP]
    # clear-sky normalized SW net within 1%; clear LW within 0.5 W/m^2
    np.testing.assert_allclose(sw_gp, sw_g, atol=0.01)
    np.testing.assert_allclose(lw_gp, lw_g, atol=0.5)
