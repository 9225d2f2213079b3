"""QuickBeam radar simulator tests.

Physics gates: Mie efficiencies against known limits, Rayleigh
consistency for small drops (Ze ~ integral N D^6), realistic dBZe for
rain/ice scenes, attenuation ordering, gas absorption magnitude, CFAD
normalization.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.satsim import radar as qb


def test_mie_small_particle_rayleigh_limit():
    """For x << 1, qbsca -> 4 x^4 |K|^2 with K=(m^2-1)/(m^2+2), and
    qext -> absorption-dominated 4 x Im(-K)."""
    m = qb.m_wat(94.0, 10.0)
    x = np.array([1e-3, 3e-3, 1e-2])
    qe, qs = qb.mie_qext_qbsca(m, x)
    K = (m ** 2 - 1.0) / (m ** 2 + 2.0)
    np.testing.assert_allclose(qs, 4.0 * x ** 4 * abs(K) ** 2, rtol=1e-2)
    np.testing.assert_allclose(qe, 4.0 * x * K.imag, rtol=1e-2)


def test_mie_large_sphere_extinction_paradox():
    """qext -> 2 for x >> 1."""
    m = qb.m_wat(94.0, 10.0)
    qe, _ = qb.mie_qext_qbsca(m, np.array([80.0, 120.0]))
    np.testing.assert_allclose(qe, 2.0, atol=0.25)


def test_water_refractive_index_94ghz():
    """m_wat at 94 GHz, 10C is ~ 3.1 - 1.8i (literature values)."""
    m = qb.m_wat(94.0, 10.0)
    assert 2.5 < m.real < 3.7
    assert 1.2 < abs(m.imag) < 2.2
    # |K|^2 near the 0.75 convention used at 94 GHz
    K2 = abs((m ** 2 - 1) / (m ** 2 + 2)) ** 2
    assert 0.65 < K2 < 0.85


def test_ice_refractive_index():
    m = qb.m_ice(94.0, -20.0)
    assert 1.7 < m.real < 1.82
    assert 0.0 < m.imag < 0.01


def _scene(npoints=2, ncol=4, nlev=20, cls_idx=2, q_gkg=0.5,
           re_um=500.0, k_cld=None):
    """One hydrometeor layer of class cls_idx (default LSR rain)."""
    z = np.linspace(16.0, 0.3, nlev)
    hgt = np.tile(z, (npoints, 1)).astype(np.float32)
    p = (1000.0 * np.exp(-z / 7.5))[None, :].repeat(npoints, 0)
    t = (15.0 - 6.5 * z)[None, :].repeat(npoints, 0)
    rh = np.full_like(p, 50.0)
    hm = np.zeros((9, npoints, ncol, nlev), np.float32)
    re = np.zeros_like(hm)
    k = nlev - 3 if k_cld is None else k_cld
    hm[cls_idx, :, :, k] = q_gkg
    re[cls_idx, :, :, k] = re_um
    return (jnp.asarray(hgt), jnp.asarray(p.astype(np.float32)),
            jnp.asarray(t.astype(np.float32)), jnp.asarray(rh),
            jnp.asarray(hm), jnp.asarray(re), k)


def test_rain_reflectivity_realistic():
    """0.5 g/kg rain with re=500um gives Ze in the 10..40 dBZ range
    (typical CloudSat rain echoes saturate ~20-40 dBZ before
    attenuation)."""
    hgt, p, t, rh, hm, re, k = _scene(q_gkg=0.5, re_um=500.0)
    out = qb.quickbeam_simulator(hgt, p, t, rh, hm, re)
    ze = np.asarray(out["ze_non"])[:, :, k]
    assert ((ze > 5.0) & (ze < 45.0)).all(), ze


def test_ice_cloud_weaker_than_rain():
    hgt, p, t, rh, hm, re, k = _scene(cls_idx=1, q_gkg=0.1, re_um=60.0,
                                      k_cld=5)
    out = qb.quickbeam_simulator(hgt, p, t, rh, hm, re)
    ze_ice = np.asarray(out["ze_non"])[:, :, 5]
    hgt, p, t, rh, hm, re, k = _scene(cls_idx=2, q_gkg=0.5, re_um=500.0)
    ze_rain = np.asarray(
        qb.quickbeam_simulator(hgt, p, t, rh, hm, re)["ze_non"])[:, :, k]
    assert (ze_ice < ze_rain.min()).all()
    assert (ze_ice > -35.0).all(), "detectable ice cloud"


def test_empty_volume_missing():
    hgt, p, t, rh, hm, re, k = _scene()
    out = qb.quickbeam_simulator(hgt, p, t, rh, hm, re)
    dbze = np.asarray(out["dbze"])
    assert (dbze[:, :, :k] == qb.MISSING_DBZ).all()


def test_attenuation_monotone_and_reduces_dbze():
    hgt, p, t, rh, hm, re, k = _scene(q_gkg=1.0, re_um=400.0)
    out = qb.quickbeam_simulator(hgt, p, t, rh, hm, re)
    g = np.asarray(out["g_atten"])
    assert (np.diff(g, axis=-1) >= 0).all(), "gas atten accumulates"
    assert g[..., -1].min() > 0.5, "two-way 94GHz gas atten is O(dB)"
    h = np.asarray(out["h_atten"])
    assert (h[..., -1] > h[..., k - 1]).all(), "hydro atten below cloud"
    dbze = np.asarray(out["dbze"])[:, :, k]
    ze = np.asarray(out["ze_non"])[:, :, k]
    assert (dbze < ze).all()


def test_cfad_normalization_and_binning():
    hgt, p, t, rh, hm, re, k = _scene(q_gkg=0.5, re_um=500.0)
    out = qb.quickbeam_simulator(hgt, p, t, rh, hm, re)
    cfad = np.asarray(qb.radar_cfad(out["dbze"]))
    assert cfad.shape == (2, 15, 20)
    # at the cloud level all columns fall in exactly one bin
    np.testing.assert_allclose(cfad[:, :, k].sum(1), 1.0, atol=1e-6)
    # clear levels (dbze=-999) are out of range: all-zero columns
    np.testing.assert_allclose(cfad[:, :, 0].sum(1), 0.0, atol=1e-6)


def test_lidar_only_freq_cloud():
    sr = np.ones((2, 4, 10), np.float32)
    dbze = np.full((2, 4, 10), qb.MISSING_DBZ, np.float32)
    sr[:, :, 4] = 30.0          # lidar cloud, radar misses
    freq, tcc = qb.lidar_only_freq_cloud(jnp.asarray(sr),
                                         jnp.asarray(dbze))
    np.testing.assert_allclose(np.asarray(freq)[:, 4], 1.0)
    np.testing.assert_allclose(np.asarray(tcc), 1.0)
    # radar sees it too -> not lidar-only
    dbze[:, :, 4] = 0.0
    freq, tcc = qb.lidar_only_freq_cloud(jnp.asarray(sr),
                                         jnp.asarray(dbze))
    np.testing.assert_allclose(np.asarray(freq)[:, 4], 0.0)
    np.testing.assert_allclose(np.asarray(tcc), 1.0)
