"""End-to-end COSP driver test: all simulators on a synthetic scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.satsim import (cosp_simulator,
                                               SatsimInputs, SatsimConfig)


@pytest.fixture(scope="module")
def scene():
    npoints, nlev = 8, 40
    rng = np.random.default_rng(3)
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.3
    ple = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    ple[:, 0] = 100.0
    play = 0.5 * (ple[:, 1:] + ple[:, :-1])
    ts = np.full((npoints,), 292.0, np.float32)
    t = np.maximum(292.0 * (play / play[:, -1:]) ** 0.22,
                   205.0).astype(np.float32)
    # hydrostatic-ish edge heights
    zle = (-7500.0 * np.log(np.maximum(ple, 1.0) / ple[:, -1:])
           ).astype(np.float32)
    qv = (0.012 * (play / play[:, -1:]) ** 3).astype(np.float32)
    z2 = np.zeros((npoints, nlev), np.float32)
    fcld = z2.copy()
    ql = z2.copy()
    qi = z2.copy()
    qr = z2.copy()
    k_liq = int(np.argmin(abs(play[0] - 75000.0)))
    k_ice = int(np.argmin(abs(play[0] - 30000.0)))
    fcld[:, k_liq] = 0.6
    ql[:, k_liq] = 1.5e-4
    fcld[:, k_ice] = 0.3
    qi[:, k_ice] = 2e-5
    qr[:, k_liq:] = 2e-5         # rain below the liquid cloud
    c = lambda v: np.full((npoints, nlev), v, np.float32)
    inp = SatsimInputs(
        ple=jnp.asarray(ple), zle=jnp.asarray(zle), t=jnp.asarray(t),
        qv=jnp.asarray(qv), fcld=jnp.asarray(fcld), qi=jnp.asarray(qi),
        ql=jnp.asarray(ql), qr=jnp.asarray(qr), qs=jnp.asarray(z2),
        qg=jnp.asarray(z2), ri=jnp.asarray(c(30e-6)),
        rl=jnp.asarray(c(12e-6)), rr=jnp.asarray(c(300e-6)),
        rs=jnp.asarray(c(100e-6)), rg=jnp.asarray(c(150e-6)),
        ts=jnp.asarray(ts),
        mcosz=jnp.asarray(np.full(npoints, 0.6, np.float32)),
        frland=jnp.asarray(np.zeros(npoints, np.float32)))
    return inp, k_liq, k_ice


@pytest.fixture(scope="module")
def result(scene):
    inp, k_liq, k_ice = scene
    out = cosp_simulator(jax.random.PRNGKey(11), inp, SatsimConfig())
    return jax.tree_util.tree_map(np.asarray, out), k_liq, k_ice


def test_all_simulator_groups_present(result):
    out, *_ = result
    for k in ("isccp", "misr", "modis", "lidar", "radar", "frac_out"):
        assert k in out, k


def test_isccp_total_cloud_consistent_with_input(result):
    out, k_liq, k_ice = result
    area = out["isccp"]["totalcldarea"]
    # max-random overlap of 0.6 and 0.3 separated layers: 1-(0.4*0.7)=0.72
    assert 0.55 < area.mean() < 0.85, area.mean()


def test_misr_detects_both_layers(result):
    out, *_ = result
    fq = out["misr"]["fq_misr"]
    assert fq.sum() > 0
    cld = out["misr"]["cldarea"]
    assert 0.4 < cld.mean() < 0.95


def test_modis_cloud_fractions_partition(result):
    out, *_ = result
    m = out["modis"]
    cf = m["cf_total"]
    assert (cf <= 1.0).all() and cf.mean() > 0.3
    # water + ice + undetermined >= water + ice
    assert (m["cf_water"] + m["cf_ice"] <= cf + 1e-6).all()
    assert m["cf_water"].mean() > 0.1, "liquid layer retrieved"


def test_lidar_sr_cloud_detected_at_layers(result):
    out, k_liq, k_ice = result
    lc = out["lidar"]["lidarcld"]
    # stats live on the 480 m stat grid (ground-ascending); map the
    # cloud layers' heights (z = -7500 ln(p/ps)) to stat bins
    b_liq = int(-7500.0 * np.log(0.75) // 480.0)
    b_ice = int(-7500.0 * np.log(0.30) // 480.0)
    assert lc[:, b_liq:b_liq + 2].max(axis=1).mean() > 0.3
    assert lc[:, b_ice:b_ice + 2].max(axis=1).mean() > 0.1
    cfad = out["lidar"]["cfad_sr"]
    np.testing.assert_allclose(cfad.sum(1), 1.0, atol=1e-5)


def test_radar_detects_rain_column(result):
    out, k_liq, k_ice = result
    dbze = out["radar"]["dbze"]
    # rain below the liquid cloud gives echoes in some subcolumns
    assert (dbze[:, :, k_liq + 2:] > -35.0).any()
    cfad = out["radar"]["cfad_dbze"]
    assert cfad.sum() > 0


def test_frac_out_population_matches_fcld(scene, result):
    inp, _, _ = scene
    out, *_ = result
    cover = (out["frac_out"] != 0).mean(axis=1)
    np.testing.assert_allclose(cover.mean(0), np.asarray(inp.fcld).mean(0),
                               atol=0.05)


def test_night_disables_isccp(scene):
    inp, *_ = scene
    inp_night = inp._replace(mcosz=jnp.zeros_like(inp.mcosz))
    out = cosp_simulator(jax.random.PRNGKey(1), inp_night,
                         SatsimConfig(run_modis=False, run_lidar=False,
                                      run_radar=False, run_misr=False))
    assert (np.asarray(out["isccp"]["totalcldarea"]) == -1e30).all()
