"""CALIPSO lidar simulator + PARASOL + LMD/IPSL stats tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.satsim import (lidar_simulator,
                                               lidar_stats, parasol)
from geosradiation_gridcomp.satsim.lidar import (S_CLD, UNDEF,
                                                     _PARASOL_TAU,
                                                     _RLUMA, _RLUMB)


def _atmos(npoints=4, nlev=30, ncol=8, q_liq=0.0, q_ice=0.0,
           p_cld=70000.0, cldcols=None):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.2
    presf = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    presf[:, 0] = 100.0
    pres = 0.5 * (presf[:, 1:] + presf[:, :-1]).astype(np.float32)
    temp = np.maximum(288.0 * (pres / pres[:, -1:]) ** 0.22,
                      210.0).astype(np.float32)
    k = int(np.argmin(abs(pres[0] - p_cld)))
    shape = (npoints, ncol, nlev)
    ql = np.zeros(shape, np.float32)
    qi = np.zeros(shape, np.float32)
    cols = slice(None) if cldcols is None else slice(0, cldcols)
    ql[:, cols, k] = q_liq
    qi[:, cols, k] = q_ice
    rad = np.full((npoints, nlev), 10.0e-6, np.float32)
    radi = np.full((npoints, nlev), 30.0e-6, np.float32)
    z = np.zeros(shape, np.float32)
    return (jnp.asarray(pres), jnp.asarray(presf), jnp.asarray(temp),
            jnp.asarray(ql), jnp.asarray(qi), jnp.asarray(z),
            jnp.asarray(z), jnp.asarray(rad), jnp.asarray(radi),
            jnp.asarray(rad), jnp.asarray(radi), k)


def test_clear_sky_signal_equals_molecular():
    """With no condensate, the total signal equals the molecular
    signal in every subcolumn (SR = 1)."""
    *args, k = _atmos()
    out = lidar_simulator(*args)
    pnorm = np.asarray(out["pnorm"])
    pmol = np.asarray(out["pmol"])
    np.testing.assert_allclose(
        pnorm, np.broadcast_to(pmol[:, None, :], pnorm.shape), rtol=1e-5)


def test_cloud_enhances_backscatter_and_attenuates_below():
    *args, k = _atmos(q_liq=5e-4)
    out = lidar_simulator(*args)
    pnorm = np.asarray(out["pnorm"])
    pmol = np.asarray(out["pmol"])
    sr = pnorm / pmol[:, None, :]
    assert (sr[:, :, k] > S_CLD).all(), "cloud layer must exceed SR=5"
    assert (sr[:, :, k + 2:] < 1.0).all(), "attenuation below cloud"
    # above the cloud: unattenuated molecular signal
    np.testing.assert_allclose(sr[:, :, :k], 1.0, rtol=1e-5)


def test_molecular_profile_decreases_with_height():
    *args, _ = _atmos()
    pmol = np.asarray(lidar_simulator(*args)["pmol"])
    # backscatter scales with density: larger near the surface (before
    # attenuation turns it over); check it grows from TOA downward in
    # the upper atmosphere
    assert (np.diff(pmol[:, :15], axis=1) > 0).all()


def test_parasol_tables_reproduced_at_nodes():
    """At table tau nodes, pure-liquid reflectance matches rlumA/cos."""
    for j, tau in enumerate(_PARASOL_TAU):
        r = np.asarray(parasol(jnp.asarray([tau]), jnp.asarray([0.0])))
        expect = _RLUMA[:, j] / np.cos(np.deg2rad([0., 20., 40., 60., 80.]))
        np.testing.assert_allclose(r[0], expect, rtol=1e-5)
    # pure ice at one node
    r = np.asarray(parasol(jnp.asarray([0.0]), jnp.asarray([10.0])))
    expect = _RLUMB[:, 3] / np.cos(np.deg2rad([0., 20., 40., 60., 80.]))
    np.testing.assert_allclose(r[0], expect, rtol=1e-5)


def test_stats_cloud_fractions():
    """Half the subcolumns carry a low cloud: low + total fractions are
    0.5, mid/high are 0."""
    *args, k = _atmos(npoints=4, ncol=16, q_liq=5e-4, p_cld=80000.0,
                      cldcols=8)
    out = lidar_simulator(*args)
    land = jnp.zeros((4,), jnp.float32)
    st = lidar_stats(out["pnorm"], out["pmol"], out["refl"], land,
                     args[0])
    cld = np.asarray(st["cldlayer"])
    np.testing.assert_allclose(cld[:, 0], 0.5, atol=1e-6)   # low
    np.testing.assert_allclose(cld[:, 3], 0.5, atol=1e-6)   # total
    np.testing.assert_allclose(cld[:, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(cld[:, 2], 0.0, atol=1e-6)
    lc = np.asarray(st["lidarcld"])
    np.testing.assert_allclose(lc[:, k], 0.5, atol=1e-6)


def test_stats_cfad_normalized():
    *args, k = _atmos(q_liq=2e-4)
    out = lidar_simulator(*args)
    st = lidar_stats(out["pnorm"], out["pmol"], out["refl"],
                     jnp.zeros((4,), jnp.float32), args[0])
    cfad = np.asarray(st["cfad_sr"])
    np.testing.assert_allclose(cfad.sum(1), 1.0, atol=1e-5)


def test_stats_parasol_land_masked():
    *args, _ = _atmos(npoints=2)
    out = lidar_simulator(*args[:11])
    land = jnp.asarray([0.0, 1.0], jnp.float32)
    st = lidar_stats(out["pnorm"], out["pmol"], out["refl"], land,
                     args[0][:2] if args[0].shape[0] != 2 else args[0])
    pr = np.asarray(st["parasolrefl"])
    assert (pr[0] > 0).all()
    assert (pr[1] == UNDEF).all()
