"""Stat-grid vertical regridding (COSP_CHANGE_VERTICAL_GRID)."""

import numpy as np
import jax.numpy as jnp

from geosradiation_gridcomp.satsim.stats import (change_vertical_grid,
                                                     csat_vgrid_bounds,
                                                     R_UNDEF)


def _ref_regrid(y, zle, zl, zu, log_units=False):
    """Direct loop transliteration-free scalar evaluation of the
    overlap-weighted mean for verification."""
    npnt, ncol, nlev = y.shape
    M = len(zl)
    r = np.full((npnt, ncol, M), R_UNDEF)
    for i in range(npnt):
        xu = zle[i, :-1]
        xl = zle[i, 1:]
        for k in range(M):
            if zu[k] <= zle[i, -1]:
                continue
            w = np.maximum(np.minimum(xu, zu[k]) - np.maximum(xl, zl[k]),
                           0.0)
            ws = w.sum()
            for j in range(ncol):
                yp = y[i, j]
                if log_units:
                    yp = np.where(yp != R_UNDEF, 10.0 ** (yp / 10.0), 0.0)
                if ws > 0:
                    v = (w * yp).sum() / ws
                    if log_units:
                        r[i, j, k] = 10 * np.log10(v) if v > 0 else R_UNDEF
                    else:
                        r[i, j, k] = v
    return r


def _grid(npnt=3, nlev=25):
    rng = np.random.default_rng(0)
    # irregular model levels from ~18 km to the surface, TOA-first
    edges = np.sort(rng.uniform(0.0, 18000.0, (npnt, nlev - 1)), axis=1)
    zle = np.concatenate([np.full((npnt, 1), 19000.0), edges[:, ::-1],
                          np.zeros((npnt, 1))], axis=1).astype(np.float32)
    return zle


def test_regrid_matches_scalar_reference():
    rng = np.random.default_rng(1)
    zle = _grid()
    y = rng.uniform(0.0, 5.0, (3, 4, 25)).astype(np.float32)
    zl, zu = csat_vgrid_bounds(40)
    got = np.asarray(change_vertical_grid(jnp.asarray(y),
                                          jnp.asarray(zle), zl, zu))
    want = _ref_regrid(y, zle, zl, zu)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_regrid_log_units():
    rng = np.random.default_rng(2)
    zle = _grid()
    y = rng.uniform(-40.0, 20.0, (3, 4, 25)).astype(np.float32)
    y[:, :, ::5] = R_UNDEF
    zl, zu = csat_vgrid_bounds(40)
    got = np.asarray(change_vertical_grid(jnp.asarray(y),
                                          jnp.asarray(zle), zl, zu,
                                          log_units=True))
    want = _ref_regrid(y, zle, zl, zu, log_units=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


def test_regrid_conserves_uniform_field():
    """A constant profile regrids to the same constant wherever bins
    overlap the model column."""
    zle = _grid()
    y = np.full((3, 2, 25), 3.25, np.float32)
    zl, zu = csat_vgrid_bounds(40)
    got = np.asarray(change_vertical_grid(jnp.asarray(y),
                                          jnp.asarray(zle), zl, zu))
    valid = got != R_UNDEF
    assert valid.any()
    np.testing.assert_allclose(got[valid], 3.25, rtol=1e-6)


def test_cosp_driver_stat_grid_shapes():
    import jax
    from geosradiation_gridcomp.satsim.cosp import (cosp_simulator,
                                                        SatsimConfig)
    from tests.test_satsim_cosp import scene
    inp = scene.__wrapped__()[0]
    cfg = SatsimConfig(ncolumns=8, nlr=40)
    out = cosp_simulator(jax.random.key(0), inp, cfg)
    npnt = inp.t.shape[0]
    assert out["radar"]["cfad_dbze"].shape == (npnt, 15, 40)
    assert out["lidar"]["cfad_sr"].shape == (npnt, 15, 40)
    assert out["radar"]["lidar_only_freq_cloud"].shape == (npnt, 40)
    # CFAD columns still normalized where clouds exist
    cf = np.asarray(out["radar"]["cfad_dbze"])
    sums = cf.sum(axis=1)
    assert ((sums <= 1.0 + 1e-5)).all()


def test_stat_grid_lidar_radar_undefined_bins_and_scan_direction():
    """On the stat grid, below-surface bins must be
    ignored (the reference's sc_ratio = R_UNDEF/R_UNDEF = 1.0 is neither
    cloud nor attenuated, llnl_stats.F90:62-70) and the first-attenuation
    scan must walk top->surface even though the stat grid is
    ground-ascending (llnl_stats.F90:109)."""
    import jax.numpy as jnp
    import numpy as np
    from geosradiation_gridcomp.satsim.radar import (
        lidar_only_freq_cloud)

    # ground-ascending bins 0..4; bin 0 undefined (sentinel 1.0 /
    # R_UNDEF), bins 1-2 attenuated below the cloud, cloud at bin 3,
    # clear above at bin 4
    sr_asc = np.array([[[1.0, 0.005, 0.005, 20.0, 0.5]]], np.float32)
    dbze_asc = np.array([[[-1.0e30, -100.0, -100.0, -100.0, -100.0]]],
                        np.float32)
    # the production path (satsim/cosp.py) flips to TOA-first
    freq, tcc = lidar_only_freq_cloud(jnp.asarray(sr_asc[..., ::-1]),
                                      jnp.asarray(dbze_asc[..., ::-1]))
    freq = np.asarray(freq)[..., ::-1]
    # cloud bin 3 counted; first attenuated bin FROM THE TOP is bin 2
    # (credited as cloud top of the attenuating layer); bin 1 (second
    # attenuated) and bin 0 (undefined) not counted
    assert freq[0].tolist() == [0.0, 0.0, 1.0, 1.0, 0.0]
    # had the scan run in ascending storage order, bin 1 would have
    # been credited instead of bin 2
    freq_wrong, _ = lidar_only_freq_cloud(jnp.asarray(sr_asc),
                                          jnp.asarray(dbze_asc))
    assert np.asarray(freq_wrong)[0].tolist() != freq[0].tolist()
    # the undefined bin must not force tcc to 1 by itself
    sr_clear = np.array([[[1.0, 0.5, 0.5, 0.5, 0.5]]], np.float32)
    dbze_clear = np.array(
        [[[-1.0e30, -100.0, -100.0, -100.0, -100.0]]], np.float32)
    _, tcc_clear = lidar_only_freq_cloud(
        jnp.asarray(sr_clear[..., ::-1]),
        jnp.asarray(dbze_clear[..., ::-1]))
    assert float(tcc_clear[0]) == 0.0
