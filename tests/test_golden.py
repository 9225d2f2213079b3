"""Fortran golden-data gate (BASELINE.json: <=1e-5 relative).

This environment has no Fortran compiler, so golden profiles must be
generated externally and dropped into tests/golden/ as .npz files; this
harness then gates every run on them. See tests/golden/README.md for
the exact offline-driver recipe and the npz schema.

Each golden file supplies inputs + expected outputs for one scheme:
  meta:     scheme ("rrtmg_lw" | "rrtmg_sw" | "chou_lw" | "chou_sw"),
            rtol (default 1e-5), atol_wm2 (default 1e-3)
  inputs:   in_<name> arrays matching the scheme's signature
  expected: out_<name> arrays (uflx/dflx/... per scheme docstring)

Clear-sky only for exact gating: McICA subcolumns are RNG-dependent, so
all-sky golden comparisons must be population-statistical (the
reference's own contract, cloud_subcol_gen.F90:24-31) and belong in a
separate stat-gate, not an allclose.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))


def _run_scheme(scheme, inp):
    if scheme == "rrtmg_lw":
        from geosradiation_gridcomp.models.rrtmg.lw import rrtmg_lw
        return rrtmg_lw(
            *(jnp.asarray(inp[k]) for k in (
                "ple", "play", "tlay", "tlev", "tsfc", "emis",
                "h2ovmr", "o3vmr", "co2vmr", "ch4vmr", "n2ovmr",
                "o2vmr", "covmr", "cfc11vmr", "cfc12vmr", "cfc22vmr",
                "ccl4vmr", "cldf", "ciwp", "clwp", "rei", "rel", "zm",
                "alat")),
            float(inp["doy"]),
            cloud_mh=int(inp.get("cloud_mh", 1)),
            cloud_lm=int(inp.get("cloud_lm", 2)))
    if scheme == "rrtmg_sw":
        from geosradiation_gridcomp.models.rrtmg.sw import rrtmg_sw
        return rrtmg_sw(
            *(jnp.asarray(inp[k]) for k in (
                "ple", "play", "tlay", "coszen", "albdir_uv",
                "albdif_uv", "albdir_nir", "albdif_nir", "h2ovmr",
                "o3vmr", "co2vmr", "ch4vmr", "o2vmr", "cldf", "ciwp",
                "clwp", "rei", "rel", "zm", "alat")),
            float(inp["doy"]),
            cloud_mh=int(inp.get("cloud_mh", 1)),
            cloud_lm=int(inp.get("cloud_lm", 2)))
    if scheme == "chou_lw":
        from geosradiation_gridcomp.models.chou_lw import chou_lw
        return chou_lw(
            *(jnp.asarray(inp[k]) for k in (
                "ple", "ta", "wa", "oa", "tb", "ts", "emis", "co2",
                "n2o", "ch4", "cfc11", "cfc12", "cfc22", "cwc", "fcld",
                "reff")),
            ict=int(inp["ict"]), icb=int(inp["icb"]))
    if scheme == "chou_sw":
        from geosradiation_gridcomp.models.chou_sw import chou_sw
        return chou_sw(
            *(jnp.asarray(inp[k]) for k in (
                "cosz", "ple", "ta", "wa", "oa", "co2", "cwc", "fcld",
                "reff")),
            rsuvbm=jnp.asarray(inp["rsuvbm"]),
            rsuvdf=jnp.asarray(inp["rsuvdf"]),
            rsirbm=jnp.asarray(inp["rsirbm"]),
            rsirdf=jnp.asarray(inp["rsirdf"]),
            ict=int(inp["ict"]), icb=int(inp["icb"]))
    raise ValueError(scheme)


@pytest.mark.skipif(not FILES, reason="no golden data present "
                    "(tests/golden/README.md documents how to make it)")
@pytest.mark.parametrize("path", FILES, ids=[os.path.basename(f)
                                             for f in FILES])
def test_golden(path):
    data = np.load(path, allow_pickle=False)
    scheme = str(data["scheme"])
    rtol = float(data["rtol"]) if "rtol" in data else 1e-5
    atol = float(data["atol_wm2"]) if "atol_wm2" in data else 1e-3
    inp = {k[3:]: data[k] for k in data.files if k.startswith("in_")}
    expect = {k[4:]: data[k] for k in data.files if k.startswith("out_")}
    assert expect, f"{path} has no out_* arrays"
    got = _run_scheme(scheme, inp)
    for name, want in expect.items():
        have = np.asarray(got[name], np.float64)
        want = np.asarray(want, np.float64)
        err = np.abs(have - want) / np.maximum(np.abs(want), atol / rtol)
        assert err.max() <= rtol, (name, float(err.max()))
