"""MISR and MODIS simulator tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.satsim import (misr_simulator,
                                               modis_l2_simulator,
                                               modis_l3_simulator)
from geosradiation_gridcomp.satsim.modis import (PHASE_LIQ, PHASE_ICE,
                                                     PHASE_NONE, R_UNDEF)


def _scene(npoints=6, nlev=24, ncol=20, z_cld=3000.0, tau=8.0,
           t_offset=0.0, cldcols=None):
    """Single-layer cloud at height z_cld with optical depth tau."""
    z = np.linspace(18000.0, 200.0, nlev)
    zfull = np.tile(z, (npoints, 1)).astype(np.float32)
    at = (288.0 - 6.5e-3 * z + t_offset)[None, :].repeat(npoints, 0)
    at = np.maximum(at, 210.0).astype(np.float32)
    k = int(np.argmin(abs(z - z_cld)))
    dtau = np.zeros((npoints, nlev), np.float32)
    dtau[:, k] = tau
    frac = np.zeros((npoints, ncol, nlev), np.int8)
    cols = slice(None) if cldcols is None else slice(0, cldcols)
    frac[:, cols, k] = 1
    return dict(zfull=jnp.asarray(zfull), at=jnp.asarray(at),
                dtau=jnp.asarray(dtau), frac=jnp.asarray(frac), k=k, z=z)


def test_misr_cth_bin_matches_cloud_height():
    """An opaque cloud at 3 km must fill the 2.5-3 km or 3-4 km CTH bin
    with the correct tau bin (tau=8 -> itau bin 3, 0-based)."""
    sc = _scene(z_cld=3000.0, tau=8.0)
    out = misr_simulator(sc["frac"], sc["zfull"], sc["at"], sc["dtau"],
                         jnp.zeros_like(sc["dtau"]),
                         jnp.ones((6,), jnp.int32))
    fq = np.asarray(out["fq_misr"])
    np.testing.assert_allclose(fq.sum((1, 2)), 1.0, atol=1e-5)
    # all mass in tau bin 3 (3.6..9.4)
    assert fq[:, 3, :].sum(-1).min() > 0.999
    cth_bin = fq[0, 3, :].argmax()
    z_detect = np.asarray(out["mean_ztop"])[0]
    assert 2000.0 <= z_detect <= 4000.0
    assert cth_bin in (7, 8)     # 3-4 km or 2.5-3 km boundaries


def test_misr_thin_cloud_no_height():
    """A tau=0.25 cloud is detected but gets the no-height bin (-1)."""
    sc = _scene(tau=0.25)
    out = misr_simulator(sc["frac"], sc["zfull"], sc["at"], sc["dtau"],
                         jnp.zeros_like(sc["dtau"]),
                         jnp.ones((6,), jnp.int32))
    ztop = np.asarray(out["box_misr_ztop"])
    assert (ztop == -1.0).all()
    fq = np.asarray(out["fq_misr"])
    assert fq[:, :, 0].sum(-1).min() > 0.999   # all mass in bin 0


def test_misr_clear_sky():
    sc = _scene(tau=0.0)
    frac = jnp.zeros_like(sc["frac"])
    out = misr_simulator(frac, sc["zfull"], sc["at"], sc["dtau"],
                         jnp.zeros_like(sc["dtau"]),
                         jnp.ones((6,), jnp.int32))
    assert np.allclose(np.asarray(out["cldarea"]), 0.0)


def test_misr_night_masked():
    sc = _scene()
    out = misr_simulator(sc["frac"], sc["zfull"], sc["at"], sc["dtau"],
                         jnp.zeros_like(sc["dtau"]),
                         jnp.zeros((6,), jnp.int32))
    assert (np.asarray(out["cldarea"]) == -1e30).all()


def _modis_scene(npoints=4, nlev=24, ncol=16, tau=10.0, phase="liq",
                 p_cld=30000.0):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.2
    plev = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    plev[:, 0] = 50.0
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    temp = np.maximum(288.0 * (play / play[:, -1:]) ** 0.22,
                      210.0).astype(np.float32)
    k = int(np.argmin(abs(play[0] - p_cld)))
    shape = (npoints, ncol, nlev)
    tl = np.zeros(shape, np.float32)
    ti = np.zeros(shape, np.float32)
    if phase == "liq":
        tl[:, :, k] = tau
    elif phase == "ice":
        ti[:, :, k] = tau
    else:
        tl[:, :, k] = tau / 2
        ti[:, :, k] = tau / 2
    sl = np.full(shape, 12.0, np.float32)
    si = np.full(shape, 40.0, np.float32)
    isccp_tau = np.full((npoints, ncol), tau, np.float32)
    isccp_ctp = np.full((npoints, ncol), p_cld / 100.0, np.float32)
    return (jnp.asarray(temp), jnp.asarray(play.astype(np.float32)),
            jnp.asarray(plev), jnp.asarray(tl), jnp.asarray(ti),
            jnp.asarray(sl), jnp.asarray(si), jnp.asarray(isccp_tau),
            jnp.asarray(isccp_ctp), k, play)


def test_modis_phase_discrimination():
    for phase, want in (("liq", PHASE_LIQ), ("ice", PHASE_ICE)):
        args = _modis_scene(phase=phase)
        out = modis_l2_simulator(*args[:9])
        assert (np.asarray(out["phase"]) == want).all(), phase


def test_modis_tau_and_ctp():
    args = _modis_scene(tau=10.0, p_cld=30000.0)
    out = modis_l2_simulator(*args[:9])
    np.testing.assert_allclose(np.asarray(out["tau"]), 10.0, rtol=1e-5)
    k, play = args[9], args[10]
    ctp = np.asarray(out["ctp"])
    # CO2 slicing: extinction-weighted pressure within the cloud layer
    plev = np.asarray(args[2])
    assert (ctp > plev[0, k]).all() and (ctp < plev[0, k + 1]).all()


def test_modis_low_cloud_uses_isccp_ctp():
    args = _modis_scene(tau=10.0, p_cld=85000.0)
    out = modis_l2_simulator(*args[:9])
    np.testing.assert_allclose(np.asarray(out["ctp"]), 85000.0, rtol=1e-4)


def test_modis_size_retrieval_recovers_input():
    """The NIR reflectance round trip should retrieve a size near the
    true particle size for a thick single-phase cloud."""
    args = _modis_scene(tau=20.0, phase="liq")
    out = modis_l2_simulator(*args[:9])
    size_um = np.asarray(out["size"]) * 1e6
    np.testing.assert_allclose(size_um, 12.0, atol=1.5)
    args = _modis_scene(tau=20.0, phase="ice")
    out = modis_l2_simulator(*args[:9])
    size_um = np.asarray(out["size"]) * 1e6
    np.testing.assert_allclose(size_um, 40.0, atol=5.0)


def test_modis_subvisible_cloud_is_none():
    args = _modis_scene(tau=0.1)
    out = modis_l2_simulator(*args[:9])
    assert (np.asarray(out["phase"]) == PHASE_NONE).all()
    assert (np.asarray(out["tau"]) == R_UNDEF).all()


def test_modis_l3_aggregation():
    args = _modis_scene(npoints=3, ncol=16, tau=10.0, phase="liq")
    l2 = modis_l2_simulator(*args[:9])
    # make half the subcolumns clear
    phase = np.asarray(l2["phase"]).copy()
    phase[:, 8:] = PHASE_NONE
    size = np.asarray(l2["size"]).copy()
    size[:, 8:] = R_UNDEF
    l3 = modis_l3_simulator(jnp.asarray(phase), l2["ctp"], l2["tau"],
                            jnp.asarray(size))
    np.testing.assert_allclose(np.asarray(l3["cf_total"]), 0.5)
    np.testing.assert_allclose(np.asarray(l3["cf_water"]), 0.5)
    np.testing.assert_allclose(np.asarray(l3["cf_ice"]), 0.0)
    np.testing.assert_allclose(np.asarray(l3["tau_water_mean"]), 10.0,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(l3["cf_high"]), 0.5)  # 300 hPa
    fq = np.asarray(l3["tau_vs_ctp"])
    np.testing.assert_allclose(fq.sum((1, 2)), 0.5, atol=1e-6)
