"""SCOPS subcolumn sampler + ISCCP simulator tests.

Validation follows the population-statistics contract (as for McICA):
per-level subcolumn cloud cover must reproduce the input cloud fraction,
overlap must behave as specified, and ISCCP diagnostics must land in the
right histogram cells for constructed cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.satsim import (scops, prec_scops,
                                               isccp_simulator)


def _cc_profile(npoints=64, nlev=20):
    cc = np.zeros((npoints, nlev), np.float32)
    cc[:, 5] = 0.4
    cc[:, 6] = 0.4
    cc[:, 12] = 0.7
    conv = np.zeros_like(cc)
    conv[:, 12] = 0.2
    return jnp.asarray(cc), jnp.asarray(conv)


def test_scops_population_cloud_cover():
    """Mean subcolumn occupancy per level == input cloud fraction."""
    cc, conv = _cc_profile(npoints=256)
    for overlap in (1, 2, 3):
        out = scops(jax.random.PRNGKey(0), cc, conv, 128, overlap=overlap)
        # population statistic: mean over points AND subcolumns
        cover = np.asarray((out != 0).mean(axis=(0, 1)))
        np.testing.assert_allclose(cover, np.asarray(cc)[0], atol=0.01,
                                   err_msg=f"overlap={overlap}")


def test_scops_convective_partition():
    """Code 2 occupancy equals the convective fraction."""
    cc, conv = _cc_profile(npoints=256)
    out = scops(jax.random.PRNGKey(1), cc, conv, 128, overlap=3)
    cv_cover = np.asarray((out == 2).mean(axis=(0, 1)))
    np.testing.assert_allclose(cv_cover, np.asarray(conv)[0], atol=0.01)


def test_scops_max_overlap_aligns_adjacent_layers():
    """With maximum overlap, adjacent layers with equal fraction must be
    occupied by the SAME subcolumns."""
    cc, conv = _cc_profile()
    out = np.asarray(scops(jax.random.PRNGKey(2), cc, conv, 64, overlap=1))
    assert (out[:, :, 5] == out[:, :, 6]).all()


def test_scops_maxran_correlates_adjacent_decorrelates_separated():
    """Max-random: adjacent cloudy layers overlap maximally; layers
    separated by clear sky are randomly overlapped."""
    cc, conv = _cc_profile(npoints=512)
    conv = jnp.zeros_like(conv)
    out = np.asarray(scops(jax.random.PRNGKey(3), cc, conv, 64, overlap=3))
    both_adj = ((out[:, :, 5] == 1) & (out[:, :, 6] == 1)).mean()
    # max overlap of 0.4/0.4 -> joint 0.4; random -> 0.16
    assert both_adj > 0.35
    both_sep = ((out[:, :, 5] == 1) & (out[:, :, 12] == 1)).mean()
    # separated by clear air: joint ~ 0.4*0.7 = 0.28
    assert abs(both_sep - 0.28) < 0.05


def test_prec_scops_precip_where_cloud_and_below():
    npoints, nsub, nlev = 8, 32, 10
    frac = np.zeros((npoints, nsub, nlev), np.int8)
    frac[:, :16, 4] = 1          # stratiform cloud in half the subcolumns
    ls = np.zeros((npoints, nlev), np.float32)
    ls[:, 4:] = 1e-4             # LS precip from cloud level to surface
    cv = np.zeros_like(ls)
    pf = np.asarray(prec_scops(jnp.asarray(ls), jnp.asarray(cv),
                               jnp.asarray(frac)))
    # at the cloud level: precip exactly in the cloudy subcolumns
    assert (pf[:, :16, 4] == 1).all() and (pf[:, 16:, 4] == 0).all()
    # below: carried down the same subcolumns
    assert (pf[:, :16, 7] == 1).all() and (pf[:, 16:, 7] == 0).all()
    # no precip where no rate
    assert (pf[:, :, :4] == 0).all()


def test_prec_scops_convective_fallback_five_percent():
    """Convective precip with no convective cloud anywhere goes into the
    first 5% of subcolumns."""
    npoints, nsub, nlev = 4, 40, 6
    frac = np.zeros((npoints, nsub, nlev), np.int8)
    cv = np.full((npoints, nlev), 1e-4, np.float32)
    ls = np.zeros_like(cv)
    pf = np.asarray(prec_scops(jnp.asarray(ls), jnp.asarray(cv),
                               jnp.asarray(frac)))
    ncv = max(int(0.05 * nsub), 1)
    assert (pf[:, :ncv, :] == 2).all()
    assert (pf[:, ncv:, :] == 0).all()


# ---------------------------------------------------------------------------
# ISCCP
# ---------------------------------------------------------------------------

def _isccp_inputs(npoints=8, nlev=30, tau_cld=10.0, p_cld=30000.0,
                  cldfrac=1.0, em_cld=0.99):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.3
    phalf = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    phalf[:, 0] = 100.0
    pfull = 0.5 * (phalf[:, 1:] + phalf[:, :-1])
    ts = np.full((npoints,), 295.0, np.float32)
    at = np.maximum(ts[:, None] * (pfull / phalf[:, -1:]) ** 0.22,
                    205.0).astype(np.float32)
    qv = (0.01 * (pfull / pfull[:, -1:]) ** 3).astype(np.float32)
    k_cld = int(np.argmin(abs(pfull[0] - p_cld)))
    cc = np.zeros_like(pfull)
    cc[:, k_cld] = cldfrac
    dtau = np.zeros_like(pfull)
    dtau[:, k_cld] = tau_cld
    dem = np.zeros_like(pfull)
    dem[:, k_cld] = em_cld
    return dict(pfull=jnp.asarray(pfull), phalf=jnp.asarray(phalf),
                qv=jnp.asarray(qv), at=jnp.asarray(at),
                skt=jnp.asarray(ts), cc=jnp.asarray(cc),
                dtau=jnp.asarray(dtau), dem=jnp.asarray(dem),
                k_cld=k_cld)


def _run_isccp(inp, ncol=50, top_height=1, cloudy_frac=1.0):
    npoints, nlev = inp["pfull"].shape
    conv = jnp.zeros((npoints, nlev), jnp.float32)
    frac = scops(jax.random.PRNGKey(7), inp["cc"], conv, ncol, overlap=3)
    sunlit = jnp.ones((npoints,), jnp.int32)
    return isccp_simulator(
        frac, inp["pfull"], inp["phalf"], inp["qv"], inp["at"],
        inp["skt"], 0.99, inp["dtau"], jnp.zeros_like(inp["dtau"]),
        inp["dem"], jnp.zeros_like(inp["dem"]), sunlit,
        top_height=top_height)


def test_isccp_overcast_thick_cloud_bins_correctly():
    """A tau=10, 300 hPa overcast cloud: totalcldarea ~ 1 and the
    histogram mass sits at itau=4 (9.4<=tau<23), ipres=2 (180-310 mb)
    or 3 (310-440) depending on the IR adjustment."""
    inp = _isccp_inputs(tau_cld=15.0, p_cld=30000.0)
    out = _run_isccp(inp)
    area = np.asarray(out["totalcldarea"])
    np.testing.assert_allclose(area, 1.0, atol=1e-5)
    fq = np.asarray(out["fq_isccp"])
    np.testing.assert_allclose(fq.sum((1, 2)), 1.0, atol=1e-5)
    # all mass in the tau bin for 9.4..23
    assert fq[:, 4, :].sum(-1).min() > 0.999
    # ptop in the upper troposphere bins (180-440 mb)
    assert (fq[:, 4, 1] + fq[:, 4, 2]).min() > 0.999


def test_isccp_mean_properties_physical():
    inp = _isccp_inputs(tau_cld=15.0, p_cld=30000.0)
    out = _run_isccp(inp)
    taucld = np.asarray(out["meantaucld"])
    np.testing.assert_allclose(taucld, 15.0, rtol=0.05)
    ptop = np.asarray(out["meanptop"])
    assert ((ptop > 150.0) & (ptop < 450.0)).all()
    tbclr = np.asarray(out["meantbclr"])
    tb = np.asarray(out["meantb"])
    assert ((tbclr > 250.0) & (tbclr < 300.0)).all()
    assert (tb < tbclr - 10.0).all(), "cold cloud lowers Tb"


def test_isccp_clear_sky_zero_area():
    inp = _isccp_inputs(cldfrac=0.0, tau_cld=0.0, em_cld=0.0)
    out = _run_isccp(inp)
    assert np.allclose(np.asarray(out["totalcldarea"]), 0.0)
    assert np.allclose(np.asarray(out["fq_isccp"]).sum((1, 2)), 0.0)
    assert np.allclose(np.asarray(out["meantaucld"]), -1e30)


def test_isccp_partial_cloud_area_matches_fraction():
    inp = _isccp_inputs(npoints=64, cldfrac=0.45, tau_cld=8.0)
    out = _run_isccp(inp, ncol=200)
    area = np.asarray(out["totalcldarea"])
    np.testing.assert_allclose(area.mean(), 0.45, atol=0.01)
    assert (np.abs(area - 0.45) < 0.15).all()


def test_isccp_model_ptop_mode():
    """top_height=2 uses the model cloud-top (half-level) pressure."""
    inp = _isccp_inputs(tau_cld=15.0, p_cld=30000.0)
    out = _run_isccp(inp, top_height=2)
    k = inp["k_cld"]
    expect = float(np.asarray(inp["phalf"])[0, k]) / 100.0
    ptop = np.asarray(out["meanptop"])
    np.testing.assert_allclose(ptop, expect, rtol=1e-3)


def test_isccp_night_masked_unless_ir_only():
    inp = _isccp_inputs()
    npoints, nlev = inp["pfull"].shape
    conv = jnp.zeros((npoints, nlev), jnp.float32)
    frac = scops(jax.random.PRNGKey(7), inp["cc"], conv, 50, overlap=3)
    night = jnp.zeros((npoints,), jnp.int32)
    out1 = isccp_simulator(
        frac, inp["pfull"], inp["phalf"], inp["qv"], inp["at"],
        inp["skt"], 0.99, inp["dtau"], jnp.zeros_like(inp["dtau"]),
        inp["dem"], jnp.zeros_like(inp["dem"]), night, top_height=1)
    assert np.allclose(np.asarray(out1["totalcldarea"]), -1e30)
    out3 = isccp_simulator(
        frac, inp["pfull"], inp["phalf"], inp["qv"], inp["at"],
        inp["skt"], 0.99, inp["dtau"], jnp.zeros_like(inp["dtau"]),
        inp["dem"], jnp.zeros_like(inp["dem"]), night, top_height=3)
    assert np.asarray(out3["totalcldarea"]).min() > 0.99
