"""Driver-layer tests: refresh/update semantics, heating rates, sharding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geosradiation_gridcomp.config import RadiationConfig, Scheme
from geosradiation_gridcomp.driver.radiation import AtmosInputs
from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                    radiation_update)
from geosradiation_gridcomp.parallel.sharding import (column_mesh,
                                                          shard_columns)
from tests.profiles import make_profile


def make_inputs(ncol=8, nlev=72, cloudy=True, seed=0):
    prof = make_profile(ncol=ncol, nlev=nlev, cloudy=cloudy, seed=seed)
    z = np.zeros(prof["ta"].shape, np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    inp = AtmosInputs(
        ple=f32(prof["ple"]), t=f32(prof["ta"]), qv=f32(prof["wa"]),
        ql=f32(prof["cwc"][..., 1]), qi=f32(prof["cwc"][..., 0]),
        qr=f32(prof["cwc"][..., 2]), qs=f32(prof["cwc"][..., 3]),
        rl=f32(prof["reff"][..., 1]), ri=f32(prof["reff"][..., 0]),
        rr=f32(prof["reff"][..., 2]), rs=f32(prof["reff"][..., 3]),
        o3=f32(prof["oa"]), fcld=f32(prof["fcld"]),
        ch4=f32(prof["ch4"]), n2o=f32(prof["n2o"]),
        cfc11=f32(prof["cfc11"]), cfc12=f32(prof["cfc12"]),
        hcfc22=f32(prof["cfc22"]), co2=f32(prof["co2"]),
        ts=f32(prof["ts"]), tsinst=f32(prof["ts"]), t2m=f32(prof["tb"]),
        emis=np.full((ncol,), 0.99, np.float32),
        albvr=np.full((ncol,), 0.1, np.float32),
        albvf=np.full((ncol,), 0.1, np.float32),
        albnr=np.full((ncol,), 0.2, np.float32),
        albnf=np.full((ncol,), 0.2, np.float32),
        lats=np.linspace(-1.0, 1.0, ncol).astype(np.float32),
        lons=np.linspace(0.0, 3.0, ncol).astype(np.float32),
    )
    return prof, inp


@pytest.fixture(scope="module")
def stepped():
    prof, inp = make_inputs()
    cfg = RadiationConfig()
    ict, icb = prof["ict"], prof["icb"]
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg, ict=ict,
                                 icb=icb)
    out = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                           inp.ple, 172.0, 12.0, config=cfg)
    return prof, inp, cfg, sol, irr, out


def test_heating_rates_magnitude(stepped):
    prof, inp, cfg, sol, irr, out = stepped
    dtdt = np.asarray(out["dtdt"]) * 86400.0
    pmid = 0.5 * (prof["ple"][:, 1:] + prof["ple"][:, :-1])
    sel = pmid > 100.0
    assert np.all(np.abs(dtdt[sel]) < 40.0), np.abs(dtdt[sel]).max()


def test_olr_export(stepped):
    _, _, _, _, _, out = stepped
    olr = np.asarray(out["lw"]["olr"])
    assert np.all(olr > 120.0) and np.all(olr < 340.0)


def test_ts_linearization_moves_fluxes(stepped):
    prof, inp, cfg, sol, irr, out = stepped
    out2 = radiation_update(sol, irr, inp.tsinst + 1.0, inp.lons, inp.lats,
                            inp.ple, 172.0, 12.0, config=cfg)
    # warming the surface by 1K raises OLR via the stored Jacobian
    d_olr = np.asarray(out2["lw"]["olr"] - out["lw"]["olr"])
    assert np.all(d_olr > 0.0) and np.all(d_olr < 6.0), d_olr


def test_sw_exports_scale_with_sun(stepped):
    prof, inp, cfg, sol, irr, out = stepped
    out_night = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                                 inp.ple, 172.0, 2.0, config=cfg)
    # different time of day changes SW but not LW
    assert not np.allclose(out_night["sw"]["fsw"], out["sw"]["fsw"])
    np.testing.assert_allclose(out_night["lw"]["flw"], out["lw"]["flw"])


def test_alw_blw_consistent(stepped):
    prof, inp, cfg, sol, irr, out = stepped
    alw = np.asarray(out["alw"])
    blw = np.asarray(out["blw"])
    # sfcem ~ alw + blw * ts
    recon = alw + blw * np.asarray(irr.ts)
    np.testing.assert_allclose(recon, np.asarray(irr.sfcem), rtol=1e-4,
                               atol=0.5)


def test_chou_scheme_config(stepped):
    prof, inp = make_inputs(ncol=4)
    cfg = RadiationConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU)
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                 ict=prof["ict"], icb=prof["icb"])
    out = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                           inp.ple, 172.0, 12.0, config=cfg)
    olr = np.asarray(out["lw"]["olr"])
    assert np.all(olr > 120.0) and np.all(olr < 340.0)
    # Chou provides no clear-sky Ts derivative: DFDTSC=0 and
    # DFDTSCNA=DFDTSC (GEOS_IrradGridComp.F90:2105-2109), while the
    # all-sky no-aerosol derivative aliases dfdts
    assert np.all(np.asarray(irr.dfdtscna) == 0.0)
    np.testing.assert_array_equal(np.asarray(irr.dfdtsna),
                                  np.asarray(irr.dfdts))


def test_rrtmgp_dfdtscna_is_clear_sky(stepped):
    """RRTMGP LW path: DFDTSCNA aliases the clear-sky derivative
    (GEOS_IrradGridComp.F90:3127,3556), distinct from the all-sky one
    in cloudy columns."""
    prof, inp = make_inputs(ncol=4)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                 ict=prof["ict"], icb=prof["icb"])
    d = np.asarray(irr.dfdtscna)
    assert np.all(np.isfinite(d)) and np.any(d != 0.0)
    # clear-sky |dF/dTs| >= all-sky at the surface (clouds shield)
    assert np.all(np.abs(d[:, -1]) >= np.abs(np.asarray(irr.dfdtsna)[:, -1])
                  - 1e-6)


def test_column_sharding_8_devices():
    """Full step over a virtual 8-device mesh: results match single-device."""
    assert len(jax.devices()) == 8
    prof, inp = make_inputs(ncol=16)
    cfg = RadiationConfig()
    ict, icb = prof["ict"], prof["icb"]
    sol_ref, irr_ref = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                         ict=ict, icb=icb)
    mesh = column_mesh()
    inp_sh = shard_columns(mesh, inp)
    sol_sh, irr_sh = radiation_refresh(inp_sh, 172.0, 12.0, config=cfg,
                                       ict=ict, icb=icb)
    np.testing.assert_allclose(np.asarray(sol_sh.flxn),
                               np.asarray(sol_ref.flxn), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(irr_sh.flx),
                               np.asarray(irr_ref.flx), rtol=2e-5, atol=0.05)


def test_column_sharding_parity_at_scale():
    """Sharded vs single-device parity at a production-scale batch
    (2048 columns, 256/device): layout/padding/collective bugs that
    16-column parity cannot see. Uses the bench
    scene generator so the workload matches the headline bench."""
    from __graft_entry__ import _example_inputs
    assert len(jax.devices()) == 8
    inp = _example_inputs(ncol=2048, nlev=72)
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    sol_ref, irr_ref = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                         ict=ict, icb=icb)
    mesh = column_mesh()
    inp_sh = shard_columns(mesh, inp)
    sol_sh, irr_sh = radiation_refresh(inp_sh, 172.0, 12.0, config=cfg,
                                       ict=ict, icb=icb)
    # per-column physics and per-column state-derived RNG seeds are
    # decomposition-invariant, so sharding changes only summation
    # layouts -> f32-roundoff-level tolerances
    np.testing.assert_allclose(np.asarray(sol_sh.flxn),
                               np.asarray(sol_ref.flxn), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(irr_sh.flx),
                               np.asarray(irr_ref.flx), rtol=2e-5,
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(irr_sh.dfdts),
                               np.asarray(irr_ref.dfdts), rtol=2e-5,
                               atol=1e-4)
