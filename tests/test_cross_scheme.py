"""Cross-scheme clear-sky physics gates.

Until Fortran golden data lands (tests/golden/), the strongest in-env
fidelity evidence is that TWO independently-built schemes - Chou
k-distribution tables (irrad.F90/sorad.F90) and RRTMG reduced-g tables
(rrtmg_lw/sw) - agree on clear-sky broadband fluxes to within the
spread the reference community itself accepts between these
k-distributions (a few W/m2; the reference's own diagnostic twins
OLCC5/LCSC5 exist exactly to cross-validate Chou vs RRTMG,
GEOS_SolarGridComp.F90 RADVAL suite). A table-extraction bug, unit
slip, or solver error in either scheme breaks the agreement.

Scope honesty: the RRTMGP leg below runs the
RRTMG-BACKED FACADE (no genuine coefficient file can enter this
zero-egress environment), so its tight gate is a facade-consistency
check, NOT a third independent build. The native RRTMGP engine is
exercised end-to-end only against synthetic coefficient sets
(tests/test_rrtmgp_driver.py, tests/test_rrtmgp_engine*.py).
"""

import numpy as np
import pytest

from geosradiation_gridcomp.config import RadiationConfig, Scheme
from geosradiation_gridcomp.driver.radiation import (irrad_refresh,
                                                         solar_refresh)
from __graft_entry__ import _example_inputs

NCOL = 8


@pytest.fixture(scope="module")
def clear_inputs():
    inp = _example_inputs(ncol=NCOL, nlev=72, seed=3)
    z = np.zeros_like(np.asarray(inp.fcld))
    import jax.numpy as jnp
    zj = jnp.asarray(z)
    return inp._replace(fcld=zj, ql=zj, qi=zj, qr=zj, qs=zj)


def _ict_icb(inp):
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    return cfg.superlayer_indices(pmid)


def _olr(scheme, inp, ict, icb):
    cfg = RadiationConfig(lw_scheme=scheme)
    irr = irrad_refresh(inp, 172.0, cfg, ict, icb)
    # net flux is downward-positive; clear-sky TOA net = -OLR
    return -np.asarray(irr.flc)[:, 0]


def _sw_clear_norm(scheme, inp, ict, icb, cosz):
    cfg = RadiationConfig(sw_scheme=scheme)
    sol = solar_refresh(inp, cosz, 172.0, cfg, ict, icb)
    # normalized (fraction-of-TOA-insolation) clear net flux profile:
    # the shared normalization cancels, so schemes compare directly
    return np.asarray(sol.flcn)


def test_lw_clear_olr_cross_scheme(clear_inputs):
    inp = clear_inputs
    ict, icb = _ict_icb(inp)
    olr = {s: _olr(s, inp, ict, icb)
           for s in (Scheme.CHOU, Scheme.RRTMG, Scheme.RRTMGP)}
    for s, v in olr.items():
        assert np.all(v > 150.0) and np.all(v < 360.0), (s, v)
    # RRTMGP facade is RRTMG-backed -> tight; Chou is an independent
    # 10-band scheme -> the accepted inter-scheme spread is a few W/m2
    d_gp = np.abs(olr[Scheme.RRTMGP] - olr[Scheme.RRTMG])
    d_chou = np.abs(olr[Scheme.CHOU] - olr[Scheme.RRTMG])
    assert d_gp.max() < 0.5, d_gp.max()
    assert d_chou.max() < 6.0, d_chou.max()  # measured 3.7
    assert d_chou.mean() < 5.0, d_chou.mean()  # measured 3.1


def test_lw_clear_sfc_down_cross_scheme(clear_inputs):
    inp = clear_inputs
    ict, icb = _ict_icb(inp)

    def sfc_down(scheme):
        cfg = RadiationConfig(lw_scheme=scheme)
        irr = irrad_refresh(inp, 172.0, cfg, ict, icb)
        return np.asarray(irr.flxd)[:, -1]

    chou = sfc_down(Scheme.CHOU)
    rrtmg = sfc_down(Scheme.RRTMG)
    assert np.all(chou > 150.0) and np.all(rrtmg > 150.0)
    d = np.abs(chou - rrtmg)
    assert d.max() < 6.0, d.max()  # measured 3.3


def test_sw_clear_net_cross_scheme(clear_inputs):
    import jax.numpy as jnp
    inp = clear_inputs
    ict, icb = _ict_icb(inp)
    cosz = jnp.clip(jnp.cos(inp.lats), 0.0, 1.0)
    day = np.asarray(cosz) > 0.2
    assert day.any()
    flc_chou = _sw_clear_norm(Scheme.CHOU, inp, ict, icb, cosz)
    flc_rrtmg = _sw_clear_norm(Scheme.RRTMG, inp, ict, icb, cosz)
    # normalized surface clear-sky net SW, daytime columns
    sfc_c = flc_chou[day, -1]
    sfc_r = flc_rrtmg[day, -1]
    assert np.all(sfc_r > 0.3) and np.all(sfc_r < 1.0)
    rel = np.abs(sfc_c - sfc_r) / sfc_r
    assert np.all(rel < 0.045), rel.max()  # measured 3.2%
