#!/usr/bin/env python
"""Golden-data pipeline glue for the offline Fortran driver.

Two subcommands:

  export --work DIR   Build clear-sky test scenes and write the raw
                      binary input files golden_in_<scheme>.bin that
                      golden_driver.F90 reads, plus a sidecar
                      golden_cases.npz holding the SAME inputs in this
                      framework's layout (TOA-first, Pa) for later
                      packaging.

  import --work DIR   Read the golden_out_<scheme>.bin files the driver
                      wrote and package tests/golden/<scheme>_clear72.npz
                      (in_* + out_* arrays per tests/golden/README.md),
                      which activates tests/test_golden.py.

Offline recipe (any machine with gfortran):
  python tools/golden_driver/make_golden.py export --work /tmp/g
  REF=/path/to/GEOSradiation_GridComp tools/golden_driver/build.sh
  for s in rrtmg_lw rrtmg_sw chou_lw chou_sw; do
      ./golden_driver /tmp/g/golden_in_$s.bin /tmp/g/golden_out_$s.bin
  done
  python tools/golden_driver/make_golden.py import --work /tmp/g
  # then commit tests/golden/*.npz

Layout conventions (mirrors the drivers):
  * RRTMG Fortran arrays are SURFACE-FIRST (rrtmg_lw_rad.F90:209);
    this framework is TOA-first -> vertical axes are flipped on export
    and the flux outputs flipped back on import.
  * Chou kernels are TOA-first in both (sorad.F90:184-186); irrad takes
    ple in Pa (irrad.F90:185), sorad takes pl in mb.
  * Binary streams are little-endian float32/int32 in Fortran
    (column-major) element order.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

NCOL, NLEV, DOY = 16, 72, 172
SCHEMES = {"rrtmg_lw": 1, "rrtmg_sw": 2, "chou_lw": 3, "chou_sw": 4}


def _f(fh, *arrays):
    for a in arrays:
        fh.write(np.asarray(a, "<f4").ravel(order="F").tobytes())


def _i(fh, *ints):
    fh.write(np.asarray(ints, "<i4").tobytes())


def _rd(fh, shape, dtype="<f4"):
    n = int(np.prod(shape))
    a = np.frombuffer(fh.read(n * 4), dtype=dtype)
    return a.reshape(shape, order="F").astype(np.float64)


def _scene():
    """Clear-sky inputs in THIS framework's layout (TOA-first)."""
    from __graft_entry__ import _example_inputs
    import jax
    inp = jax.tree_util.tree_map(
        np.asarray, _example_inputs(ncol=NCOL, nlev=NLEV, seed=7))
    z = np.zeros_like(inp.fcld)
    inp = inp._replace(fcld=z, ql=z, qi=z, qr=z, qs=z)
    return inp


def _derived(inp):
    play = 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1]) * 0.01   # hPa
    from geosradiation_gridcomp.models.rrtmg.lw import (
        level_temperatures, mid_heights)
    tlev = np.asarray(level_temperatures(play, inp.t, inp.ple * 0.01,
                                         inp.ts))
    zm = np.asarray(mid_heights(play, inp.t, inp.ple[:, -1]))
    h2ovmr = inp.qv / (1.0 - inp.qv) * (28.964 / 18.015)
    o3vmr = inp.o3 * (28.964 / 47.998)
    return play, tlev, zm, h2ovmr, o3vmr


def export(work):
    os.makedirs(work, exist_ok=True)
    inp = _scene()
    play, tlev, zm, h2ovmr, o3vmr = _derived(inp)
    ncol, nlay = play.shape
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])
    cmh, clm = 28, 47        # 1-based TOA-first superlayer boundaries
    cmh_f, clm_f = nlay + 1 - cmh, nlay + 1 - clm   # surface-first
    c = lambda v: np.full_like(play, v)

    cases = {}

    # ---- rrtmg_lw ----------------------------------------------------
    emis16 = np.repeat(inp.emis[:, None], 16, axis=1)
    lw = dict(ple=inp.ple, play=play, tlay=inp.t, tlev=tlev,
              tsfc=inp.tsinst, emis=emis16, h2ovmr=h2ovmr, o3vmr=o3vmr,
              co2vmr=inp.co2, ch4vmr=inp.ch4, n2ovmr=inp.n2o,
              o2vmr=c(0.2095), covmr=c(0.0), cfc11vmr=inp.cfc11,
              cfc12vmr=inp.cfc12, cfc22vmr=inp.hcfc22, ccl4vmr=c(0.0),
              cldf=inp.fcld, ciwp=c(0.0), clwp=c(0.0),
              rei=inp.ri, rel=inp.rl, zm=zm, alat=inp.lats,
              doy=float(DOY), cloud_mh=cmh, cloud_lm=clm)
    cases.update({f"rrtmg_lw/{k}": v for k, v in lw.items()})
    with open(os.path.join(work, "golden_in_rrtmg_lw.bin"), "wb") as fh:
        _i(fh, SCHEMES["rrtmg_lw"], ncol, nlay)
        _f(fh, flip(play), flip(inp.ple * 0.01), flip(inp.t),
           flip(tlev), inp.tsinst, emis16)
        for k in ("h2ovmr", "o3vmr", "co2vmr", "ch4vmr", "n2ovmr",
                  "o2vmr", "cfc11vmr", "cfc12vmr", "cfc22vmr",
                  "ccl4vmr", "cldf", "ciwp", "clwp", "rei", "rel"):
            _f(fh, flip(lw[k]))
        _f(fh, np.zeros((ncol, nlay, 16)), flip(zm), inp.lats)
        _i(fh, DOY, clm_f, cmh_f, 3, 1, 1)

    # ---- rrtmg_sw ----------------------------------------------------
    cosz = np.clip(np.cos(inp.lats), 0.15, 1.0)     # all daytime
    sw = dict(ple=inp.ple, play=play, tlay=inp.t, coszen=cosz,
              albdir_uv=inp.albvr, albdif_uv=inp.albvf,
              albdir_nir=inp.albnr, albdif_nir=inp.albnf,
              h2ovmr=h2ovmr, o3vmr=o3vmr, co2vmr=inp.co2,
              ch4vmr=inp.ch4, o2vmr=c(0.2095), cldf=inp.fcld,
              ciwp=c(0.0), clwp=c(0.0), rei=inp.ri, rel=inp.rl,
              zm=zm, alat=inp.lats, doy=float(DOY),
              cloud_mh=cmh, cloud_lm=clm)
    cases.update({f"rrtmg_sw/{k}": v for k, v in sw.items()})
    with open(os.path.join(work, "golden_in_rrtmg_sw.bin"), "wb") as fh:
        _i(fh, SCHEMES["rrtmg_sw"], ncol, nlay)
        _f(fh, np.float32(1361.0), np.float32(1.0), cosz,
           flip(play), flip(inp.ple * 0.01), flip(inp.t))
        for k in ("h2ovmr", "o3vmr", "co2vmr", "ch4vmr", "o2vmr",
                  "cldf", "ciwp", "clwp", "rei", "rel"):
            _f(fh, flip(sw[k]))
        _f(fh, flip(zm), inp.lats, np.zeros((ncol, nlay, 14)),
           np.zeros((ncol, nlay, 14)), np.zeros((ncol, nlay, 14)),
           inp.albvr, inp.albvf, inp.albnr, inp.albnf)
        #    isolvar dyofyr cloudLM cloudMH ice liq iaer normFlx inhm
        _i(fh, -1, DOY, clm_f, cmh_f, 3, 1, 0, 0, 1)

    # ---- chou_lw (both TOA-first; ple in Pa, irrad.F90:185) ----------
    emis10 = np.repeat(inp.emis[:, None], 10, axis=1)
    cwc = np.zeros((ncol, nlay, 4), np.float32)
    reff = np.stack([inp.ri, inp.rl, np.full_like(play, 100.0),
                     np.full_like(play, 80.0)], axis=-1)
    clw = dict(ple=inp.ple, ta=inp.t, wa=inp.qv, oa=inp.o3,
               tb=inp.t2m, ts=inp.tsinst, emis=emis10, co2=inp.co2,
               n2o=inp.n2o, ch4=inp.ch4, cfc11=inp.cfc11,
               cfc12=inp.cfc12, cfc22=inp.hcfc22, cwc=cwc,
               fcld=inp.fcld, reff=reff, ict=cmh, icb=clm)
    cases.update({f"chou_lw/{k}": v for k, v in clw.items()})
    with open(os.path.join(work, "golden_in_chou_lw.bin"), "wb") as fh:
        _i(fh, SCHEMES["chou_lw"], ncol, nlay)
        _f(fh, inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
           emis10, np.float32(4.0e-4), inp.n2o, inp.ch4, inp.cfc11,
           inp.cfc12, inp.hcfc22, cwc, inp.fcld, reff,
           np.zeros((ncol, nlay, 10)), np.zeros((ncol, nlay, 10)),
           np.zeros((ncol, nlay, 10)))
        _i(fh, cmh, clm, 1)

    # ---- chou_sw (TOA-first; pl in mb, sorad.F90:96) -----------------
    csw = dict(cosz=cosz, ple=inp.ple, ta=inp.t, wa=inp.qv, oa=inp.o3,
               co2=np.full_like(play, 4.0e-4), cwc=cwc, fcld=inp.fcld,
               reff=reff, rsuvbm=inp.albvr, rsuvdf=inp.albvf,
               rsirbm=inp.albnr, rsirdf=inp.albnf, ict=cmh, icb=clm)
    cases.update({f"chou_sw/{k}": v for k, v in csw.items()})
    with open(os.path.join(work, "golden_in_chou_sw.bin"), "wb") as fh:
        _i(fh, SCHEMES["chou_sw"], ncol, nlay)
        _f(fh, cosz, inp.ple * 0.01, inp.t, inp.qv, inp.o3,
           np.float32(4.0e-4), cwc, inp.fcld, reff,
           np.zeros((ncol, nlay, 8)), np.zeros((ncol, nlay, 8)),
           np.zeros((ncol, nlay, 8)), inp.albvr, inp.albvf,
           inp.albnr, inp.albnf)
        _i(fh, cmh, clm)

    np.savez(os.path.join(work, "golden_cases.npz"),
             **{k.replace("/", "__"): v for k, v in cases.items()},
             ncol=ncol, nlay=nlay)
    print(f"wrote golden_in_*.bin + golden_cases.npz under {work}")


def import_(work):
    golden_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests", "golden")
    side = np.load(os.path.join(work, "golden_cases.npz"))
    ncol, nlay = int(side["ncol"]), int(side["nlay"])
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])

    def inputs_of(scheme):
        pre = scheme + "__"
        return {f"in_{k[len(pre):]}": side[k] for k in side.files
                if k.startswith(pre)}

    def pack(scheme, outs, rtol=1e-5):
        path = os.path.join(golden_dir, f"{scheme}_clear{nlay}.npz")
        np.savez(path, scheme=scheme, rtol=rtol, atol_wm2=1e-3,
                 **inputs_of(scheme),
                 **{f"out_{k}": v for k, v in outs.items()})
        print("wrote", path)

    with open(os.path.join(work, "golden_out_rrtmg_lw.bin"), "rb") as fh:
        lev = (ncol, nlay + 1)
        uflx, dflx, uflxc, dflxc, du, duc = (_rd(fh, lev)
                                             for _ in range(6))
        olrb = _rd(fh, (16, ncol)).T
        _ = _rd(fh, (16, ncol))
        pack("rrtmg_lw", dict(uflx=flip(uflx), dflx=flip(dflx),
                              uflxc=flip(uflxc), dflxc=flip(dflxc),
                              duflx_dts=flip(du), duflxc_dts=flip(duc),
                              olrb=olrb))

    with open(os.path.join(work, "golden_out_rrtmg_sw.bin"), "rb") as fh:
        lev = (ncol, nlay + 1)
        fu, fd, fuc, fdc = (_rd(fh, lev) for _ in range(4))
        nirr, nirf, parr, parf, uvrr, uvrf = (_rd(fh, (ncol,))
                                              for _ in range(6))
        fswband = _rd(fh, (ncol, 14))
        drband = _rd(fh, (ncol, 14))
        dfband = _rd(fh, (ncol, 14))
        pack("rrtmg_sw", dict(bbfu=flip(fu), bbfd=flip(fd),
                              bbcu=flip(fuc), bbcd=flip(fdc),
                              nirr=nirr, nirf=nirf, parr=parr,
                              parf=parf, uvrr=uvrr, uvrf=uvrf,
                              fndsbnd=fswband, drband=drband,
                              dfband=dfband))

    with open(os.path.join(work, "golden_out_chou_lw.bin"), "rb") as fh:
        lev = (ncol, nlay + 1)
        names = ("flxu", "flcu", "flau", "flxau", "flxd", "flcd",
                 "flad", "flxad", "dfdts")
        outs = {k: _rd(fh, lev) for k in names}
        outs["sfcem"] = _rd(fh, (ncol,))
        pack("chou_lw", outs)

    with open(os.path.join(work, "golden_out_chou_sw.bin"), "rb") as fh:
        lev = (ncol, nlay + 1)
        outs = {k: _rd(fh, lev) for k in ("flx", "flc", "flxu", "flcu")}
        for k in ("fdiruv", "fdifuv", "fdirpar", "fdifpar", "fdirir",
                  "fdifir"):
            outs[k] = _rd(fh, (ncol,))
        outs["flx_sfc_band"] = _rd(fh, (ncol, 8))
        outs["drband"] = _rd(fh, (ncol, 8))
        outs["dfband"] = _rd(fh, (ncol, 8))
        pack("chou_sw", outs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["export", "import"])
    ap.add_argument("--work", required=True)
    args = ap.parse_args()
    if args.cmd == "export":
        export(args.work)
    else:
        import_(args.work)


if __name__ == "__main__":
    main()
