"""Driver infrastructure: clock, checkpoint restart, validation, lazy
diagnostics."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geosradiation_gridcomp.config import RadiationConfig
from geosradiation_gridcomp.driver.clock import RadiationClock
from geosradiation_gridcomp.driver.checkpoint import (save_checkpoint,
                                                          load_checkpoint)
from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                    radiation_update)
from geosradiation_gridcomp.driver.validate import (validate_inputs,
                                                        check_finite)
from tests.test_driver import make_inputs


# ---------------------------------------------------------------- clock

def test_clock_refresh_cadence():
    clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    assert clk.alarm_ringing()          # t=0 is a refresh boundary
    acts = [clk.tick() for _ in range(4)]
    # refresh every second heartbeat, update every heartbeat
    assert acts == [["update"], ["refresh", "update"],
                    ["update"], ["refresh", "update"]]


def test_clock_called_last_ordering():
    clk = RadiationClock(run_dt=3600.0, solar_dt=3600.0, called_last=True)
    assert clk.tick() == ["update", "refresh"]


def test_clock_rejects_non_multiple():
    with pytest.raises(ValueError):
        RadiationClock(run_dt=1800.0, solar_dt=2500.0)


def test_clock_time_queries():
    clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0, start_doy=100.0,
                         start_utc_hours=23.0)
    for _ in range(4):
        clk.tick()
    assert clk.utc_hours == pytest.approx(1.0)
    assert clk.doy == pytest.approx(100.0 + 2.0 / 24.0)


# ----------------------------------------------------------- checkpoint

def _run_sequence(inp, cfg, ict, icb, clk, nsteps, sol=None, irr=None):
    outs = []
    for _ in range(nsteps):
        for act in clk.tick():
            if act == "refresh":
                sol, irr = radiation_refresh(inp, clk.doy, clk.utc_hours,
                                             config=cfg, ict=ict, icb=icb)
            else:
                outs.append(radiation_update(
                    sol, irr, inp.tsinst, inp.lons, inp.lats, inp.ple,
                    clk.doy, clk.utc_hours, config=cfg))
    return sol, irr, outs


def test_checkpoint_restart_bitwise(tmp_path):
    """Stop/restart mid-interval reproduces the uninterrupted run exactly
    (the reference's restart contract, GEOS_SolarGridComp.F90:117-119)."""
    prof, inp = make_inputs(ncol=4, nlev=40)
    cfg = RadiationConfig()
    ict, icb = prof["ict"], prof["icb"]

    # uninterrupted: refresh at t=0 then 4 heartbeats
    clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    sol0, irr0 = radiation_refresh(inp, clk.doy, clk.utc_hours,
                                   config=cfg, ict=ict, icb=icb)
    _, _, outs_ref = _run_sequence(inp, cfg, ict, icb, clk, 4,
                                   sol=sol0, irr=irr0)

    # interrupted after 2 heartbeats (mid refresh interval)
    clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    sol, irr = radiation_refresh(inp, clk.doy, clk.utc_hours,
                                 config=cfg, ict=ict, icb=icb)
    sol, irr, outs_a = _run_sequence(inp, cfg, ict, icb, clk, 2,
                                     sol=sol, irr=irr)
    path = os.fspath(tmp_path / "rad_checkpoint.npz")
    save_checkpoint(path, solar=sol, irrad=irr, clock=clk)

    ck = load_checkpoint(path)
    sol2, irr2, clk2 = ck["solar"], ck["irrad"], ck["clock"]
    assert clk2.time_s == clk.time_s
    _, _, outs_b = _run_sequence(inp, cfg, ict, icb, clk2, 2,
                                 sol=sol2, irr=irr2)

    outs_restart = outs_a + outs_b
    assert len(outs_restart) == len(outs_ref)
    for a, b in zip(outs_restart, outs_ref):
        la, lb = (jax.tree_util.tree_flatten_with_path(x)[0]
                  for x in (a, b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, va), (_, vb) in zip(la, lb):
            np.testing.assert_array_equal(
                np.asarray(va), np.asarray(vb),
                err_msg=jax.tree_util.keystr(path))


def test_checkpoint_roundtrip_fields(tmp_path):
    prof, inp = make_inputs(ncol=4, nlev=40)
    cfg = RadiationConfig()
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                 ict=prof["ict"], icb=prof["icb"])
    path = os.fspath(tmp_path / "ck.npz")
    save_checkpoint(path, solar=sol, irrad=irr,
                    extra={"note": "test"})
    ck = load_checkpoint(path)
    assert ck["extra"] == {"note": "test"}
    for field in sol._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sol, field)),
                                      np.asarray(getattr(ck["solar"],
                                                         field)))
    for field in irr._fields:
        np.testing.assert_array_equal(np.asarray(getattr(irr, field)),
                                      np.asarray(getattr(ck["irrad"],
                                                         field)))


# ----------------------------------------------------------- validation

def test_validate_accepts_good_inputs():
    _, inp = make_inputs(ncol=4, nlev=40)
    validate_inputs(inp)


def test_validate_rejects_garbage():
    _, inp = make_inputs(ncol=4, nlev=40)
    bad = inp._replace(t=np.full_like(np.asarray(inp.t), 500.0))
    with pytest.raises(ValueError, match="AtmosInputs.t"):
        validate_inputs(bad)
    bad = inp._replace(qv=np.asarray(inp.qv) * np.nan)
    with pytest.raises(ValueError, match="non-finite"):
        validate_inputs(bad)
    ple = np.asarray(inp.ple).copy()
    ple[:, 3] = ple[:, 2] - 1.0
    with pytest.raises(ValueError, match="monoton|increase"):
        validate_inputs(inp._replace(ple=ple))


def test_check_finite_catches_nan():
    prof, inp = make_inputs(ncol=4, nlev=40)
    cfg = RadiationConfig()
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=cfg,
                                 ict=prof["ict"], icb=prof["icb"])
    check_finite(sol, "SolarState")          # clean state passes
    poisoned = irr._replace(flx=np.asarray(irr.flx) * np.nan)
    with pytest.raises(FloatingPointError, match="flx"):
        check_finite(poisoned, "IrradState")


# ---------------------------------------------------- lazy diagnostics

def test_lazy_diagnostics_prune_update():
    """Pruned outputs vanish from the export dict AND from the traced
    program (the associated-pointer idiom,
    GEOS_RadiationGridComp.F90:743-785)."""
    prof, inp = make_inputs(ncol=4, nlev=40)
    full = RadiationConfig()
    lean = RadiationConfig(outputs=frozenset())
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=full,
                                 ict=prof["ict"], icb=prof["icb"])
    out_full = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                                inp.ple, 172.0, 12.0, config=full)
    assert "tbrb" in out_full["lw"] and "olrb" in out_full["lw"]
    assert "flx_sfc_band" in out_full["sw"]

    out_lean = radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                                inp.ple, 172.0, 12.0, config=lean)
    assert "tbrb" not in out_lean["lw"] and "olrb" not in out_lean["lw"]
    assert "flx_sfc_band" not in out_lean["sw"]

    # the Planck inversion (log1p) must be gone from the traced program
    jaxpr = jax.make_jaxpr(
        lambda s, i, t: radiation_update(s, i, t, inp.lons, inp.lats,
                                         inp.ple, 172.0, 12.0,
                                         config=lean))(sol, irr, inp.tsinst)
    assert "log1p" not in str(jaxpr)


def test_lazy_diagnostics_prune_refresh():
    prof, inp = make_inputs(ncol=4, nlev=40)
    lean = RadiationConfig(outputs=frozenset())
    sol, irr = radiation_refresh(inp, 172.0, 12.0, config=lean,
                                 ict=prof["ict"], icb=prof["icb"])
    assert np.all(np.asarray(irr.olrb) == 0.0)
    assert np.all(np.asarray(irr.dolrb_dts) == 0.0)
    # fluxes still live
    assert np.isfinite(np.asarray(irr.flx)).all()
    assert np.isfinite(np.asarray(sol.flxn)).all()
