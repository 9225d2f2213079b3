"""Properties of the one code path each stage keeps.

* Per-column physics does not depend on column order, which is why the LW
  driver needs no column sort.
* Daylight packing with the driver's bounds reproduces the unpacked
  refresh on a mixed day/night, clear/cloudy scene, and grazing-sun
  columns keep their net flux within the insolation.
* The table interpolations (row-gather form) agree with a float64 numpy
  interpolation.
* Every matrix product of the refresh asks for HIGHEST precision, so no
  scheme falls to TF32 on a GPU.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry__ import _example_inputs  # noqa: E402
from geosradiation_gridcomp.config import RadiationConfig, Scheme  # noqa
from geosradiation_gridcomp.driver.astronomy import mean_cos_zenith  # noqa
from geosradiation_gridcomp.driver.step import (  # noqa: E402
    radiation_refresh, sw_partition_bounds)
from geosradiation_gridcomp.models.rrtmg import cldprmc_lw, cldprmc_sw
from geosradiation_gridcomp.models.rrtmg import setcoef_lw
from geosradiation_gridcomp.models.rrtmg.lw import (  # noqa: E402
    level_temperatures, mid_heights, rrtmg_lw)
from geosradiation_gridcomp.models.rrtmg.spcvmc import MU0_MIN  # noqa
from geosradiation_gridcomp.tables import load  # noqa: E402


def _scene(ncol, seed=0):
    inp = _example_inputs(ncol=ncol, nlev=72, seed=seed)
    cfg = RadiationConfig()
    ict, icb = cfg.superlayer_indices(
        0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1]))
    return inp, cfg, ict, icb


def _lw_args(inp):
    ncol = inp.t.shape[0]
    play = 0.005 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    tlev = level_temperatures(play, inp.t, inp.ple * 0.01, inp.ts)
    dp = inp.ple[:, 1:] - inp.ple[:, :-1]
    c = lambda v: jnp.full_like(play, v)
    cf = jnp.maximum(inp.fcld, 1e-6)
    return (inp.ple, play, inp.t, tlev, inp.ts,
            jnp.broadcast_to(inp.emis[:, None], (ncol, 16)),
            inp.qv / (1.0 - inp.qv) * (28.964 / 18.015),
            inp.o3 * (28.964 / 47.998), c(4.1e-4), c(1.8e-6), c(3.2e-7),
            c(0.209), c(1.5e-7), c(2.3e-10), c(5.2e-10), c(2.4e-10),
            c(8e-11), inp.fcld, 1000.0 * inp.qi * dp / 9.80665 / cf,
            1000.0 * inp.ql * dp / 9.80665 / cf, inp.ri, inp.rl,
            mid_heights(play, inp.t, inp.ple[:, -1]), inp.lats, 172.0)


def test_rrtmg_lw_invariant_under_column_permutation():
    inp, _, ict, icb = _scene(12)
    args = _lw_args(inp)
    perm = np.random.default_rng(1).permutation(12)
    out = rrtmg_lw(*args, cloud_mh=ict, cloud_lm=icb)
    outp = rrtmg_lw(*(a[perm] if getattr(a, "ndim", 0) >= 1 else a
                      for a in args), cloud_mh=ict, cloud_lm=icb)
    for k in out:
        np.testing.assert_array_equal(np.asarray(outp[k]),
                                      np.asarray(out[k])[perm], err_msg=k)


def test_refresh_packing_bounds_reproduce_unpacked():
    # 512 columns spanning all longitudes: about half are night, and the
    # 3-deck scene leaves some lit columns clear
    inp, cfg, ict, icb = _scene(512, seed=4)
    nlit, ncld = sw_partition_bounds(inp.lons, inp.lats, inp.fcld, 172.0,
                                     12.0, cfg, bucket=32)
    assert nlit is not None and ncld is not None
    kw = dict(config=cfg, ict=ict, icb=icb)
    full = radiation_refresh(inp, 172.0, 12.0, **kw)
    packed = radiation_refresh(inp, 172.0, 12.0, sw_nlit=nlit,
                               sw_ncld=ncld, **kw)
    lit = np.asarray(full[0].flxn)[:, 0] > 0.0
    assert 0 < lit.sum() < 512
    for name in ("flxn", "flcn", "flxun", "flcun"):
        a = np.asarray(getattr(packed[0], name))
        b = np.asarray(getattr(full[0], name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
        assert not a[~lit].any(), name
    for a, b in zip(jax.tree.leaves(packed[1]), jax.tree.leaves(full[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grazing_sun_net_flux_within_insolation():
    # the columns of a fine global grid nearest the terminator see a
    # refresh-mean cos(zenith) down to ~1e-5, below the solver's MU0_MIN:
    # their normalized net TOA flux must still be a fraction <= 1
    inp, cfg, ict, icb = _scene(32768)
    slr, lit = mean_cos_zenith(inp.lons, inp.lats, 172.0, 12.0,
                               cfg.solar_dt / 3600.0)
    zth = np.asarray(jnp.where(lit > 0.0, slr / jnp.maximum(lit, 1e-6),
                               9.0))
    cols = np.argsort(zth)[:8]
    assert zth[cols].min() < MU0_MIN
    sub = jax.tree.map(lambda x: x[cols], inp)
    sol, _ = radiation_refresh(sub, 172.0, 12.0, config=cfg, ict=ict,
                               icb=icb)
    net = np.asarray(sol.flxn)[:, 0]
    assert (net > 0.0).all() and (net <= 1.0).all(), net


def _np_interp(tab, index, fint):
    tab = np.asarray(tab, np.float64)
    lo = tab[np.asarray(index) - 1]
    hi = tab[np.asarray(index)]
    return lo + np.asarray(fint, np.float64)[..., None] * (hi - lo)


@pytest.mark.parametrize("which", ["planck", "cldprmc_lw", "cldprmc_sw"])
def test_interp_rows_match_float64(which):
    rng = np.random.default_rng(5)
    if which == "planck":
        tab = np.asarray(setcoef_lw.lw_tables()["totplnk"])
        t = rng.uniform(160.0, 339.0, (7, 11)).astype(np.float32)
        got = setcoef_lw._planck_interp(tab, jnp.asarray(t))
        ind = np.clip(np.floor(t - 159.0).astype(np.int32), 1, 180)
        want = _np_interp(tab, ind, t.astype(np.float64) - 159.0 - ind)
    else:
        tab = (load("rrtmg_lw_cld")["absliq1"] if which == "cldprmc_lw"
               else load("rrtmg_sw_cld")["extliq1"])
        tab = np.asarray(tab, np.float32)
        index = rng.integers(1, tab.shape[0], (7, 11)).astype(np.int32)
        fint = rng.uniform(0.0, 1.0, (7, 11)).astype(np.float32)
        mod = cldprmc_lw if which == "cldprmc_lw" else cldprmc_sw
        got = mod._interp_rows(jnp.asarray(tab), jnp.asarray(index),
                               jnp.asarray(fint))
        want = _np_interp(tab, index, fint)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6,
                               atol=1e-6 * np.abs(want).max())


def _dot_precisions(jaxpr, found):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for j in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(j, jax.extend.core.ClosedJaxpr):
                    _dot_precisions(j.jaxpr, found)
                elif isinstance(j, jax.extend.core.Jaxpr):
                    _dot_precisions(j, found)
    return found


@pytest.mark.parametrize("scheme", [Scheme.RRTMG, Scheme.CHOU,
                                    Scheme.RRTMGP])
def test_every_dot_is_highest_precision(scheme):
    inp, cfg, ict, icb = _scene(4)
    cfg = dataclasses.replace(cfg, sw_scheme=scheme, lw_scheme=scheme)
    jaxpr = jax.make_jaxpr(lambda x: radiation_refresh(
        x, 172.0, 12.0, config=cfg, ict=ict, icb=icb))(inp)
    found = _dot_precisions(jaxpr.jaxpr, [])
    assert found, "no dot_general traced"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    bad = [p for p in found if p not in (highest, lax.Precision.HIGHEST)]
    assert not bad, f"{len(bad)} of {len(found)} dots: {bad[:3]}"
