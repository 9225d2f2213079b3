"""RRTMGP-path tests: sampling primitives, facade metadata, and
cross-validation of the generic rte solvers against the RRTMG scheme."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmgp import (
    GasConcs, KDistSW, KDistLW, rrtmgp_sw, rrtmgp_lw,
    sampled_mask_max_ran, sampled_urand_gen_max_ran, draw_samples)
from tests.profiles import make_profile
from tests.test_rrtmg_sw import run_sw
from tests.test_rrtmg_lw import run_lw


# ---------------------------------------------------------------------------
# sampling primitives
# ---------------------------------------------------------------------------

def test_sampled_mask_max_ran_statistics():
    """Per-level cover matches cloud fraction; adjacent layers maximally
    overlap; separated layers randomly overlap."""
    ncol, ngpt, nlay = 400, 64, 10
    cf = np.zeros((ncol, nlay), np.float32)
    cf[:, 2] = 0.4
    cf[:, 3] = 0.4
    cf[:, 7] = 0.5
    urand = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                          (ncol, ngpt, nlay)))
    mask = np.asarray(sampled_mask_max_ran(jnp.asarray(urand),
                                           jnp.asarray(cf)))
    assert mask.shape == (ncol, nlay, ngpt)
    cover = mask.mean(axis=(0, 2))
    np.testing.assert_allclose(cover, cf[0], atol=0.01)
    # maximum overlap of adjacent equal layers: identical masks
    assert (mask[:, 2, :] == mask[:, 3, :]).all()
    # random overlap across the clear gap: joint ~ 0.4*0.5
    joint = (mask[:, 3, :] & mask[:, 7, :]).mean()
    assert abs(joint - 0.2) < 0.02


def test_gen_max_ran_correlation_limits():
    """alpha=1 reuses the layer-above deviates; alpha=0 keeps fresh."""
    ncol, ngpt, nlay = 8, 32, 6
    key = jax.random.PRNGKey(1)
    u = jax.random.uniform(key, (ncol, ngpt, nlay))
    aux = jax.random.uniform(jax.random.PRNGKey(2), (ncol, ngpt, nlay))
    ones = jnp.ones((ncol, nlay - 1))
    out = np.asarray(sampled_urand_gen_max_ran(ones, u, aux))
    for k in range(1, nlay):
        np.testing.assert_array_equal(out[..., k], out[..., 0])
    zeros = jnp.zeros((ncol, nlay - 1))
    out0 = np.asarray(sampled_urand_gen_max_ran(zeros, u, aux))
    np.testing.assert_array_equal(out0, np.asarray(u))


def test_draw_samples_band_to_gpt():
    lims = np.array([[1, 3], [4, 5]])     # 2 bands, 5 gpts
    props = {"tau": jnp.asarray(np.arange(2 * 3 * 2, dtype=np.float32)
                                .reshape(2, 3, 2))}
    mask = jnp.ones((2, 3, 5), bool).at[0, 0, 0].set(False)
    out = np.asarray(draw_samples(mask, props, lims)["tau"])
    # gpts 0-2 get band 0, gpts 3-4 band 1
    band = np.asarray(props["tau"])
    assert out[1, 2, 1] == band[1, 2, 0]
    assert out[1, 2, 4] == band[1, 2, 1]
    assert out[0, 0, 0] == 0.0            # masked cell


# ---------------------------------------------------------------------------
# facade metadata
# ---------------------------------------------------------------------------

def test_kdist_metadata():
    sw, lw = KDistSW(), KDistLW()
    assert sw.get_ngpt() == 112 and sw.get_nband() == 14
    assert lw.get_ngpt() == 140 and lw.get_nband() == 16
    assert sw.source_is_external() and not lw.source_is_external()
    gl = sw.get_band_lims_gpoint()
    assert gl[0, 0] == 1 and gl[-1, 1] == 112
    wn = lw.get_band_lims_wavenumber()
    assert wn[0, 0] == 10.0 and wn[-1, 1] == 3250.0


def test_gas_concs_validation():
    g = GasConcs()
    with pytest.raises(KeyError):
        GasConcs(names=("h2o",)).set_vmr("co2", 1e-4)
    g.set_vmr("co2", 410e-6)
    like = jnp.zeros((3, 4))
    assert g.get_vmr("co2", like=like).shape == (3, 4)
    assert float(g.get_vmr("n2o", like=like)[0, 0]) == 0.0


# ---------------------------------------------------------------------------
# cross-validation against the RRTMG scheme
# ---------------------------------------------------------------------------

def _sw_args(prof, cosz=0.7, albedo=0.1):
    ncol, nlev = prof["ta"].shape
    from geosradiation_gridcomp.models.rrtmg.lw import mid_heights
    ple = prof["ple"]
    play = (0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01).astype(np.float32)
    zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
    o3 = prof["oa"] * (28.966 / 47.9982)
    h2o = prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
    dp = ple[:, 1:] - ple[:, :-1]
    icq = np.where(prof["fcld"] > 0,
                   1.0 / np.maximum(prof["fcld"], 1e-6), 0.0)
    ciwp = (prof["cwc"][..., 0] * dp * 1e3 / 9.80665 * icq
            ).astype(np.float32)
    clwp = (prof["cwc"][..., 1] * dp * 1e3 / 9.80665 * icq
            ).astype(np.float32)
    alb = np.full((ncol,), albedo, np.float32)
    mu = np.full((ncol,), cosz, np.float32)
    return (ple, play, prof["ta"], mu, alb, alb, alb, alb,
            h2o.astype(np.float32), o3.astype(np.float32), prof["co2"],
            prof["ch4"], np.full_like(prof["co2"], 0.2095),
            prof["fcld"], ciwp, clwp,
            np.full_like(prof["fcld"], 60.0),
            np.full_like(prof["fcld"], 10.0),
            zm, np.full((ncol,), 0.7, np.float32), 100.0)


def test_rrtmgp_sw_clear_sky_matches_rrtmg():
    """With the mean-sun NRLSSI2 source the clear-sky fluxes from the
    RRTMGP plumbing must track the RRTMG scheme (same k-tables, same
    two-stream) to well under 1 W/m^2 relative differences are from the
    solar source decomposition (NRLSSI2 vs Kurucz), so compare shapes
    via normalized profiles."""
    prof = make_profile(ncol=3, nlev=60, cloudy=False)
    prof["ict"], prof["icb"] = 18, 28
    args = _sw_args(prof)
    out_gp = rrtmgp_sw(*args)
    # RRTMG with isolvar=2 at mean indices = same NRLSSI2 mean sun
    out_g = run_sw(prof, cosz=0.7, scon=0.0, isolvar=2)
    dn_gp = np.asarray(out_gp["bbcd"])
    dn_g = np.asarray(out_g["bbcd"])
    up_gp = np.asarray(out_gp["bbcu"])
    up_g = np.asarray(out_g["bbcu"])
    np.testing.assert_allclose(dn_gp, dn_g, rtol=2e-3, atol=0.3)
    np.testing.assert_allclose(up_gp, up_g, rtol=5e-3, atol=0.3)


def test_rrtmgp_sw_allsky_physical():
    prof = make_profile(ncol=4, nlev=60, cloudy=True)
    args = _sw_args(prof)
    out = rrtmgp_sw(*args)
    dn = np.asarray(out["bbfd"])
    up = np.asarray(out["bbfu"])
    assert np.isfinite(dn).all() and np.isfinite(up).all()
    assert (up <= dn + 1e-3).all(), "no net upward SW"
    # clouds brighten the planet
    assert (np.asarray(out["bbfu"][:, 0])
            > np.asarray(out["bbcu"][:, 0])).all()


def test_rrtmgp_lw_clear_sky_matches_rrtmg():
    prof = make_profile(ncol=3, nlev=60, cloudy=False)
    prof["ict"], prof["icb"] = 18, 28
    ncol, nlev = prof["ta"].shape
    from geosradiation_gridcomp.models.rrtmg.lw import mid_heights
    ple = prof["ple"]
    play = (0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01).astype(np.float32)
    zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
    o3 = (prof["oa"] * (28.966 / 47.9982)).astype(np.float32)
    h2o = (prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
           ).astype(np.float32)
    emis = np.full((ncol, 16), 0.99, np.float32)
    dp = ple[:, 1:] - ple[:, :-1]
    z2 = np.zeros_like(prof["fcld"])
    out_gp = rrtmgp_lw(
        ple, play, prof["ta"], prof["ts"], emis,
        h2o, o3, prof["co2"], prof["ch4"], prof["n2o"],
        np.full_like(prof["co2"], 0.209),
        prof["cfc11"], prof["cfc12"], prof["cfc22"],
        z2, z2, z2, np.full_like(z2, 60.0), np.full_like(z2, 10.0),
        zm, np.full((ncol,), 0.7, np.float32), 100.0,
        ccl4vmr=np.full_like(prof["co2"], 100e-12))
    out_g = run_lw(prof)
    np.testing.assert_allclose(np.asarray(out_gp["flux_up_clr"]),
                               np.asarray(out_g["uflxc"]),
                               rtol=1e-5, atol=0.01)
    np.testing.assert_allclose(np.asarray(out_gp["flux_dn_clr"]),
                               np.asarray(out_g["dflxc"]),
                               rtol=1e-5, atol=0.01)


def test_rrtmgp_lw_cloud_reduces_olr():
    prof = make_profile(ncol=3, nlev=60, cloudy=True)
    ncol, nlev = prof["ta"].shape
    from geosradiation_gridcomp.models.rrtmg.lw import mid_heights
    ple = prof["ple"]
    play = (0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01).astype(np.float32)
    zm = np.asarray(mid_heights(play, prof["ta"], ple[:, -1]))
    o3 = (prof["oa"] * (28.966 / 47.9982)).astype(np.float32)
    h2o = (prof["wa"] * (28.966 / 18.016) / (1.0 - prof["wa"])
           ).astype(np.float32)
    emis = np.full((ncol, 16), 0.99, np.float32)
    dp = ple[:, 1:] - ple[:, :-1]
    icq = np.where(prof["fcld"] > 0,
                   1.0 / np.maximum(prof["fcld"], 1e-6), 0.0)
    ciwp = (prof["cwc"][..., 0] * dp * 1e3 / 9.80665 * icq
            ).astype(np.float32)
    clwp = (prof["cwc"][..., 1] * dp * 1e3 / 9.80665 * icq
            ).astype(np.float32)
    out = rrtmgp_lw(
        ple, play, prof["ta"], prof["ts"], emis,
        h2o, o3, prof["co2"], prof["ch4"], prof["n2o"],
        np.full_like(prof["co2"], 0.209),
        prof["cfc11"], prof["cfc12"], prof["cfc22"],
        prof["fcld"], ciwp, clwp,
        np.full_like(prof["fcld"], 60.0), np.full_like(prof["fcld"], 10.0),
        zm, np.full((ncol,), 0.7, np.float32), 100.0)
    olr_all = np.asarray(out["flux_up"][:, 0])
    olr_clr = np.asarray(out["flux_up_clr"][:, 0])
    assert (olr_all < olr_clr - 1.0).all(), "clouds reduce OLR"
    assert (olr_all > 120.0).all() and (olr_clr < 350.0).all()
