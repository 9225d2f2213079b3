"""The gather-engine taumol paths against the per-band references.

The gather-layout engines (taumol_lw / taumol_sw_fast), which the refresh
runs, must reproduce the per-band reference engines (taumol_*_ref) to f32
summation-order roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmg import lw as lwmod
from geosradiation_gridcomp.models.rrtmg.setcoef_lw import setcoef_lw
from geosradiation_gridcomp.models.rrtmg.setcoef_sw import setcoef_sw
from geosradiation_gridcomp.models.rrtmg.taumol_lw import (
    taumol_lw, taumol_lw_ref)
from geosradiation_gridcomp.models.rrtmg.taumol_sw import (
    taumol_sw_fast, taumol_sw_ref)

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs as example_inputs


@pytest.fixture(scope="module")
def lw_coefs():
    inp = example_inputs(ncol=16, nlev=72)
    play = 0.01 * 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    plev = inp.ple * 0.01
    tlay = inp.t
    tlev = lwmod.level_temperatures(play, tlay, plev, inp.ts)
    emis = jnp.broadcast_to(inp.emis[:, None], (16, 16))
    h2o = inp.qv / (1.0 - inp.qv) * (28.964 / 18.015)
    o3 = inp.o3 * (28.964 / 47.998)
    c = lambda v: jnp.full_like(play, v)
    return inp, play, plev, tlay, tlev, emis, setcoef_lw(
        play, tlay, plev, tlev, inp.ts, emis, h2o, o3,
        c(4e-4), c(1.8e-6), c(3.2e-7), c(0.209), c(1.5e-7),
        c(2e-10), c(4e-10), c(1e-10), c(8e-11), dudts=True)


def _relmax(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.abs(a - b) / (np.abs(b) + 1e-12)).max()


def test_taumol_lw_fast_matches_ref(lw_coefs):
    *_, coefs = lw_coefs
    tg_f, pf_f = taumol_lw(coefs)
    tg_r, pf_r = taumol_lw_ref(coefs)
    assert _relmax(tg_f, tg_r) < 5e-6
    assert _relmax(pf_f, pf_r) < 5e-6


def test_taumol_lw_fast_aerosol(lw_coefs):
    *_, coefs = lw_coefs
    taua = jnp.full(coefs.jp.shape + (16,), 0.01, jnp.float32)
    tg_f, _ = taumol_lw(coefs, taua)
    tg_r, _ = taumol_lw_ref(coefs, taua)
    assert _relmax(tg_f, tg_r) < 5e-6


def test_taumol_lw_chunked_matches_unchunked(lw_coefs):
    # 16 columns x 72 layers = 1152 cells in chunks of 500 (padded last
    # chunk); the full LWCoefs carries per-column fields that must pass
    # through the chunking untouched
    *_, coefs = lw_coefs
    tg_c, pf_c = taumol_lw(coefs, col_chunk=500)
    tg_f, pf_f = taumol_lw(coefs)
    # same arithmetic per cell; only XLA's vectorization of the chunk
    # shape may change the last bit
    assert _relmax(tg_c, tg_f) < 5e-6
    assert _relmax(pf_c, pf_f) < 5e-6


def test_taumol_sw_fast_matches_ref():
    inp = example_inputs(ncol=16, nlev=72)
    play = 0.01 * 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    plev = inp.ple * 0.01
    h2o = inp.qv / (1.0 - inp.qv) * (28.964 / 18.015)
    o3 = inp.o3 * (28.964 / 47.998)
    c = lambda v: jnp.full_like(play, v)
    coefs = setcoef_sw(play, inp.t, plev, h2o, o3, c(4e-4), c(1.8e-6),
                       c(0.2095))
    a = taumol_sw_fast(coefs)
    b = taumol_sw_ref(coefs)
    for x, y in zip(a, b):
        assert _relmax(x, y) < 5e-6
