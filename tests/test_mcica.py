"""Population-statistics tests for the McICA subcolumn generator.

The reference's own contract is population equivalence, not sample
equivalence (cloud_subcol_gen.F90:24-31).
"""

import numpy as np
import jax.numpy as jnp

from geosradiation_gridcomp.ops.mcica import (
    generate_stochastic_clouds, clear_counts_three_band, zcw_lookup,
    correlation_length, AAM1, AAM2, AAM30, AAM4)


def setup_inputs(ncol=1, nlay=40, nsub=2000, cf=0.3, dz=500.0):
    zmid = np.linspace(20000.0, 500.0, nlay)[None, :] * np.ones((ncol, 1))
    if dz != 500.0:
        zmid = np.linspace(dz * nlay, dz, nlay)[None, :] * np.ones((ncol, 1))
    alat = np.full((ncol,), 0.7)
    play = np.linspace(100.0, 1000.0, nlay)[None, :] * np.ones((ncol, 1))
    play = play + 0.4567  # fractional Pa for seeding
    cldfrac = np.zeros((ncol, nlay), np.float32)
    cldfrac[:, 15:25] = cf
    ciwp = np.where(cldfrac > 0, 10.0, 0.0).astype(np.float32)
    clwp = np.where(cldfrac > 0, 20.0, 0.0).astype(np.float32)
    return dict(zmid=zmid.astype(np.float32), alat=alat.astype(np.float32),
                doy=100, play=play.astype(np.float32), cldfrac=cldfrac,
                ciwp=ciwp, clwp=clwp, cwp_tiny=1e-3)


def test_layer_cloud_fraction_reproduced():
    inp = setup_inputs(nsub=1024, cf=0.4)
    cldy, _, _ = generate_stochastic_clouds(**inp, nsubcol=1024, inhm=0)
    frac = np.asarray(cldy[0]).mean(axis=0)
    np.testing.assert_allclose(frac[15:25], 0.4, atol=0.05)
    assert np.all(frac[:15] == 0.0) and np.all(frac[25:] == 0.0)


def test_max_overlap_limit():
    # adjacent thin layers (dz -> 0) are perfectly correlated: total cloud
    # cover equals max layer fraction
    inp = setup_inputs(dz=1.0, cf=0.5)
    cldy, _, _ = generate_stochastic_clouds(**inp, nsubcol=1024, inhm=0)
    cover = np.asarray(jnp.any(cldy[0], axis=-1)).mean()
    np.testing.assert_allclose(cover, 0.5, atol=0.05)


def test_random_overlap_limit():
    # hugely separated layers: total cover ~ 1 - prod(1 - cf)
    inp = setup_inputs(dz=50000.0, cf=0.2)
    cldy, _, _ = generate_stochastic_clouds(**inp, nsubcol=1024, inhm=0)
    cover = np.asarray(jnp.any(cldy[0], axis=-1)).mean()
    expect = 1.0 - (1.0 - 0.2) ** 10
    np.testing.assert_allclose(cover, expect, atol=0.06)


def test_condensate_mean_preserved():
    inp = setup_inputs(cf=1.0)  # overcast: every subcolumn cloudy
    cldy, ciwp_s, clwp_s = generate_stochastic_clouds(
        **inp, nsubcol=1024, inhm=1)
    mean_scale = np.asarray(ciwp_s[0, :, 20]).mean() / 10.0
    # beta-distribution scaling preserves the mean to within sampling error
    np.testing.assert_allclose(mean_scale, 1.0, atol=0.05)


def test_determinism_and_seed_order():
    inp = setup_inputs()
    a = generate_stochastic_clouds(**inp, nsubcol=128, inhm=1)
    b = generate_stochastic_clouds(**inp, nsubcol=128, inhm=1)
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    c = generate_stochastic_clouds(**inp, nsubcol=128, inhm=1,
                                   seed_order=(3, 2, 1, 0))
    assert not np.array_equal(np.asarray(a[0]), np.asarray(c[0]))


def test_zcw_homogeneous_is_one():
    z = zcw_lookup(jnp.linspace(0.0, 1.0, 11), jnp.full((11,), 0.5), 0)
    np.testing.assert_allclose(np.asarray(z), 1.0)


def test_zcw_mean_near_one():
    cdf = jnp.linspace(0.001, 0.999, 2001)
    for sig in (0.5, 0.71, 1.0):
        z = zcw_lookup(cdf, jnp.full_like(cdf, sig), 1)
        np.testing.assert_allclose(np.asarray(z).mean(), 1.0, atol=0.05)


def test_clear_counts():
    inp = setup_inputs(cf=0.5)
    cldy, _, _ = generate_stochastic_clouds(**inp, nsubcol=256, inhm=0)
    counts = np.asarray(clear_counts_three_band(cldy, 12, 30))
    # clouds are in layers 16-25 (1-based), i.e. the mid band [12, 29]
    assert np.all(counts[:, 1] == 256)     # high band all clear
    assert np.all(counts[:, 3] == 256)     # low band all clear
    assert np.all(counts[:, 0] == counts[:, 2])  # total == mid


def test_correlation_length_positive():
    cl = correlation_length(AAM1, AAM2, AAM30, AAM4, 180,
                            jnp.linspace(-1.5, 1.5, 7))
    assert np.all(np.asarray(cl) > 1000.0)
