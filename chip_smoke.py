#!/usr/bin/env python
"""Smoke test of the radiation refresh on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --devices 4  # phase 6 only: the 4-GPU column mesh

1. Device: a GPU is required (there is no CPU fallback); prints the card,
   its power limit and the JAX setup.
2. Main path: radiation_refresh + radiation_update at 8192 columns x 72
   levels (the realistic 3-deck scene, daylight packing on) over a few
   refresh times, and once at 181 levels.
3. Reference: the first 1024 columns rerun with the same code on the host
   CPU in this process; fluxes and heating rates compared.
4. Other schemes: Chou, the RRTMGP facade and COSP, each against the CPU.
5. The rtrnmc Pallas kernel against the jnp sweep on the GPU, and the
   refresh timed with each, in turns.
6. (--devices 4) the refresh sharded over a 4-GPU column mesh against
   single-GPU runs of the same columns, with the collectives XLA inserted.

Any failure ends the run with a traceback and a non-zero exit code. The
last line of output is one JSON object with "ok" and the device. Times
printed here are smoke timings, not benchmark results.
"""

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np

NCOL, NLEV = 8192, 72
NCOL_DEEP, NLEV_DEEP = 2048, 181
NREF = 1024               # columns rerun on the CPU (phase 3)
NSCHEME = 256             # columns per scheme comparison (phase 4)
TIMES = ((172.0, 12.0), (172.0, 18.0), (355.0, 6.0))   # (doy, utc h)

# ------------------------------------------------------------------ helpers

def require_gpu(count=1):
    """The first `count` GPU devices; raises when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError("chip_smoke needs an NVIDIA GPU; JAX found "
                           f"{devs[0].platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"chip_smoke needs {count} GPUs; JAX found "
                           f"{len(devs)}")
    return devs[:count]


def col_err(got, want, scale=None):
    """Per-column error relative to the column's scale: max over the
    trailing axes of |got - want| / scale, where scale defaults to
    max |want| of the column (columns whose values are all zero use an
    absolute error)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    if scale is None:
        scale = np.abs(want).max(axis=1)
    err = np.abs(got - want).max(axis=1)
    return err / np.where(scale > 0.0, scale, 1.0)


def check_close(name, got, want, tol, share=0.0, reason="", scale=None):
    """Require at most `share` of the columns beyond `tol` (col_err)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = col_err(got, want, scale)
    beyond = float((err > tol).mean())
    print(f"  {name}: col err median {np.median(err):.2e}, p99 "
          f"{np.quantile(err, 0.99):.2e}, max {err.max():.2e}; "
          f"{100 * beyond:.3f}% of columns beyond {tol:g} (limit "
          f"{100 * share:g}%) - {reason}")
    if beyond > share:
        raise AssertionError(f"{name}: {100 * beyond:.3f}% of columns "
                             f"beyond {tol:g}")


def check_heating(got, want, ple, tol, share=0.0):
    """dtdt of two update-output lists compared as each layer's net flux
    divergence (dtdt * cp * dp / g, W/m^2) relative to the column's flux
    scale (max |SW net| + max |LW net|, W/m^2). Float32 rounding is
    a fixed fraction of the flux, so in thin layers (the scene's top
    layers are 0.01-0.1 Pa thick) it makes heating-rate differences of
    order 1 K/day between any two platforms; the divergence is what the
    flux tolerances bound."""
    from geosradiation_gridcomp.constants import CP, GRAV
    dp = np.diff(np.asarray(ple, np.float64), axis=-1) * CP / GRAV
    scale = (np.abs(np.asarray(want[0]["sw"]["fsw"])).max(axis=1)
             + np.abs(np.asarray(want[0]["lw"]["flw"])).max(axis=1))
    check_close("heating", np.asarray(got[0]["dtdt"], np.float64) * dp,
                np.asarray(want[0]["dtdt"], np.float64) * dp, tol, share,
                "layer flux divergence over the column flux scale",
                scale=scale)


def check_mean(name, got, want, tol, reason=""):
    """Require |mean(got - want)| <= tol (same units as the arrays)."""
    d = float(np.mean(np.asarray(got, np.float64)
                      - np.asarray(want, np.float64)))
    print(f"  {name}: mean diff {d:+.4f} (limit {tol:g}) - {reason}")
    if not abs(d) <= tol:
        raise AssertionError(f"{name}: mean diff {d:+.4f} > {tol:g}")


def scene(ncol, nlev, seed=0):
    """Host inputs of the realistic 3-deck scene and the static config."""
    import jax
    from __graft_entry__ import _example_inputs
    from geosradiation_gridcomp.config import RadiationConfig

    inp = jax.tree.map(np.asarray, _example_inputs(ncol=ncol, nlev=nlev,
                                                   seed=seed))
    cfg = RadiationConfig()
    ict, icb = cfg.superlayer_indices(0.5 * (inp.ple[0, 1:]
                                             + inp.ple[0, :-1]))
    return inp, dict(config=cfg, ict=ict, icb=icb)


def packing_bounds(inp, kw, times):
    """sw_nlit / sw_ncld valid at every refresh time (as bench.py)."""
    from geosradiation_gridcomp.driver.step import sw_partition_bounds

    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, u,
                                  kw["config"]) for d, u in times]
    pick = lambda i: (None if any(b[i] is None for b in bounds)
                      else max(b[i] for b in bounds))
    return dict(kw, sw_nlit=pick(0), sw_ncld=pick(1))


def run_hour(inp, kw, doy, utc, refresh=None):
    """One refresh and the solar_dt / run_dt heartbeat updates after it.
    refresh: a compiled radiation_refresh for these inputs, or None."""
    import jax
    from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                    radiation_update)

    cfg = kw["config"]
    if refresh is None:
        sol, irr = radiation_refresh(inp, doy, utc, **kw)
    else:
        sol, irr = refresh(inp, doy, utc)
    steps = int(round(cfg.solar_dt / cfg.run_dt))
    ups = [radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                            inp.ple, doy, utc + i * cfg.run_dt / 3600.0,
                            config=cfg) for i in range(steps)]
    return jax.block_until_ready((sol, irr, ups))


def to_host(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def check_physics(sol, irr, ups, tag):
    """Finite outputs, OLR in 150..350 W/m^2, SW net <= TOA insolation."""
    import jax
    for leaf in jax.tree.leaves((sol, irr, ups)):
        if not np.isfinite(np.asarray(leaf)).all():
            raise AssertionError(f"{tag}: non-finite output")
    olr = np.asarray(ups[0]["lw"]["olr"])
    if not (olr.min() > 150.0 and olr.max() < 350.0):
        raise AssertionError(f"{tag}: OLR range {olr.min()}..{olr.max()}")
    net_toa = np.asarray(sol.flxn)[:, 0]     # net / TOA insolation
    if not net_toa.max() <= 1.0 + 1e-5:
        raise AssertionError(f"{tag}: SW net above insolation "
                             f"({net_toa.max()})")
    dtdt = np.asarray(ups[0]["dtdt"]) * 86400.0
    print(f"  {tag}: physics ok; OLR {olr.min():.1f}..{olr.max():.1f} "
          f"W/m2, max SW net/insolation {net_toa.max():.4f}, "
          f"|dtdt| max {np.abs(dtdt).max():.1f} K/day")


def compile_refresh(inp, kw, doy, utc):
    """AOT-compile radiation_refresh; returns (compiled, seconds)."""
    from geosradiation_gridcomp.driver.step import radiation_refresh
    t0 = time.perf_counter()
    compiled = radiation_refresh.lower(inp, doy, utc, **kw).compile()
    return compiled, time.perf_counter() - t0


def count_compiles(fn):
    """(fn(), number of XLA backend compilations while it ran)."""
    import jax

    n = [0]

    def listener(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            n[0] += 1

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        out = fn()
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)
    return out, n[0]


def timed_hours(inp, kw, times, refresh=None):
    """Seconds per refresh hour (one refresh + its updates), averaged."""
    t0 = time.perf_counter()
    for doy, utc in times:
        run_hour(inp, kw, doy, utc, refresh)
    return (time.perf_counter() - t0) / len(times)


# ------------------------------------------------------------------- phases

def device_phase(count=1):
    import jax
    import jaxlib
    from geosradiation_gridcomp.runtime import use_compile_cache

    devs = require_gpu(count)
    print(f"[1] device: {devs[0].device_kind}, {len(jax.devices())} "
          f"visible, using {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"  nvidia-smi: {smi}")
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {use_compile_cache()}")
    return devs


def main_path_phase(dev, ncol=NCOL, nlev=NLEV, times=TIMES):
    """Refresh + updates at a real size on `dev`; returns (host inputs,
    static kwargs, host outputs of the first hour, compiled refresh)."""
    import jax

    print(f"[2] main path: {ncol} columns x {nlev} levels on "
          f"{dev.device_kind}")
    inp_h, kw = scene(ncol, nlev)
    kw = packing_bounds(inp_h, kw, times)
    print(f"  daylight packing: sw_nlit={kw['sw_nlit']}, "
          f"sw_ncld={kw['sw_ncld']}")
    inp = jax.device_put(inp_h, dev)
    compiled, t_comp = compile_refresh(inp, kw, *times[0])
    mem = compiled.memory_analysis()
    print(f"  refresh compile {t_comp:.1f} s; memory_analysis: "
          f"temp {mem.temp_size_in_bytes / 2**30:.2f} GiB, args "
          f"{mem.argument_size_in_bytes / 2**30:.3f} GiB, outputs "
          f"{mem.output_size_in_bytes / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    first = to_host(run_hour(inp, kw, *times[0]))
    print(f"  first hour through the entry points (loads or compiles "
          f"the update): {time.perf_counter() - t0:.1f} s")
    per_hour, ncomp = count_compiles(lambda: timed_hours(inp, kw, times))
    stats = dev.memory_stats() or {}
    print(f"  smoke timing (not a benchmark): {1e3 * per_hour:.1f} ms per "
          f"refresh hour (1 refresh + updates) over {len(times)} hours")
    print(f"  compilations after warm-up: {ncomp}; peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
    if ncomp:
        raise AssertionError(f"{ncomp} compilations after warm-up")
    check_physics(*first, f"{ncol}x{nlev}")
    return inp_h, kw, first, compiled


def deep_phase(dev, ncol=NCOL_DEEP, nlev=NLEV_DEEP, times=TIMES[:1]):
    import jax

    print(f"[2b] {ncol} columns x {nlev} levels")
    inp_h, kw = scene(ncol, nlev, seed=1)
    kw = packing_bounds(inp_h, kw, times)
    t0 = time.perf_counter()
    out = to_host(run_hour(jax.device_put(inp_h, dev), kw, *times[0]))
    print(f"  compile + first hour {time.perf_counter() - t0:.1f} s")
    check_physics(*out, f"{ncol}x{nlev}")


def compare_states(got, want, ple, tag):
    """Phase-3 comparison of (sol, irr, ups) host outputs."""
    (gs, gi, gu), (ws, wi, wu) = got, want
    print(f"  {tag}:")
    # clear sky is deterministic: only summation order and exp differ
    check_close("LW clear net flux", gi.flc, wi.flc, 5e-5,
                reason="float32 order of sums")
    check_close("SW clear net flux", gs.flcn, ws.flcn, 5e-4, 0.005,
                reason="float32 order; conservative-scattering edge")
    check_close("SW clear up flux", gs.flcun, ws.flcun, 5e-4, 0.005,
                reason="float32 order; conservative-scattering edge")
    # all sky: a McICA subcolumn can flip cloudy/clear on a last-bit
    # difference of a threshold, which moves that column's fluxes
    why = "McICA threshold flips on last-bit differences"
    for name, g, w in (("LW net flux", gi.flx, wi.flx),
                       ("LW up flux", gi.flxu, wi.flxu),
                       ("SW net flux", gs.flxn, ws.flxn),
                       ("SW up flux", gs.flxun, ws.flxun)):
        check_close(name, g, w, 1e-3, 0.005, why)
    check_heating(gu, wu, ple, 1e-3, 0.005)
    # flips move single columns both ways; a bias would move the mean
    for i, lev in ((0, "TOA"), (-1, "surface")):
        for band, key in (("LW", "flw"), ("SW", "fsw")):
            check_mean(f"{band} net {lev} W/m2",
                       gu[0][band.lower()][key][:, i],
                       wu[0][band.lower()][key][:, i], 0.01,
                       "a bias shows in the mean")


def reference_phase(dev, cpu, inp_h, kw, got, nref=NREF, times=TIMES):
    """The first nref columns of the phase-2 run against the same code
    on the host CPU (per-column physics and McICA seeds do not depend on
    the other columns)."""
    import jax

    print(f"[3] reference: first {nref} columns rerun on {cpu.platform}")
    sub = jax.tree.map(lambda x: x[:nref], inp_h)
    kw_sub = packing_bounds(sub, {k: kw[k] for k in ("config", "ict",
                                                      "icb")}, times)
    t0 = time.perf_counter()
    want = to_host(run_hour(jax.device_put(sub, cpu), kw_sub, *times[0]))
    print(f"  CPU run {time.perf_counter() - t0:.1f} s")
    got = jax.tree.map(lambda x: x[:nref], got)
    compare_states(got, want, sub.ple, f"{dev.platform} vs {cpu.platform}")


def scheme_phase(dev, cpu, ncol=NSCHEME, nlev=NLEV):
    """Chou, the RRTMGP facade and COSP on `dev` against the CPU."""
    import dataclasses

    import jax
    from geosradiation_gridcomp.config import Scheme
    from geosradiation_gridcomp.satsim import (SatsimConfig, SatsimInputs,
                                               cosp_simulator)

    print(f"[4] other schemes: {ncol} columns x {nlev} levels")
    inp_h, kw = scene(ncol, nlev, seed=2)
    doy, utc = TIMES[0]
    why = "McICA threshold flips; TF32 would show here"
    for scheme in (Scheme.CHOU, Scheme.RRTMGP):
        kws = dict(kw, config=dataclasses.replace(
            kw["config"], sw_scheme=scheme, lw_scheme=scheme))
        got, want = (to_host(run_hour(jax.device_put(inp_h, d), kws, doy,
                                      utc)) for d in (dev, cpu))
        print(f"  {scheme.name}:")
        check_physics(*got, scheme.name)
        check_close("LW net flux", got[1].flx, want[1].flx, 1e-3, 0.005,
                    why)
        check_close("SW net flux", got[0].flxn, want[0].flxn, 1e-3, 0.005,
                    why)
        check_heating(got[2], want[2], inp_h.ple, 1e-3, 0.005)

    # COSP on the same scene (radii in m, heights from the hypsometric eq.)
    t = inp_h.t
    lnp = np.log(inp_h.ple)
    tlev = np.concatenate([t[:, :1], t], axis=1)
    dz = 287.04 * tlev[:, 1:] / 9.80665 * (lnp[:, 1:] - lnp[:, :-1])
    zle = np.concatenate([np.cumsum(dz[:, ::-1], axis=1)[:, ::-1],
                          np.zeros((ncol, 1))], axis=1).astype(np.float32)
    zero = np.zeros_like(t)
    sat = SatsimInputs(
        ple=inp_h.ple, zle=zle, t=t, qv=inp_h.qv, fcld=inp_h.fcld,
        qi=inp_h.qi, ql=inp_h.ql, qr=zero, qs=zero, qg=zero,
        ri=inp_h.ri * 1e-6, rl=inp_h.rl * 1e-6, rr=inp_h.rr * 1e-6,
        rs=inp_h.rs * 1e-6, rg=np.full_like(t, 150e-6), ts=inp_h.ts,
        mcosz=np.full((ncol,), 0.5, np.float32),
        frland=np.zeros((ncol,), np.float32))
    key = jax.random.key(7)
    got, want = (to_host(cosp_simulator(jax.device_put(key, d),
                                        jax.device_put(sat, d),
                                        SatsimConfig()))
                 for d in (dev, cpu))
    print("  COSP:")
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(want)
    for (path, g), w in zip(flat_g, flat_w):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind != "f" or g.ndim == 0 or g.shape[0] != ncol:
            continue
        name = jax.tree_util.keystr(path)
        # UNDEF fills (night, no cloud) are compared as they are
        check_close(f"COSP {name}", g, w, 1e-3, 0.005,
                    "subcolumn threshold flips")


def kernel_phase(dev, compiled_kernel, inp_h, kw, ncol=NCOL,
                 nlevs=(NLEV, NLEV_DEEP), times=TIMES):
    """The rtrnmc Pallas kernel against the jnp sweep, and the refresh
    with each (A/B/B/A) at the phase-2 size."""
    import jax
    from geosradiation_gridcomp.models.rrtmg import lw as lwmod
    from geosradiation_gridcomp.models.rrtmg.rtrnmc import rtrnmc
    from geosradiation_gridcomp.models.rrtmg.rtrnmc_gpu import (
        KERNEL_NAME, rtrnmc_triton)

    print("[5] rtrnmc Pallas kernel vs the jnp sweep")
    hlo = compiled_kernel.as_text()
    if KERNEL_NAME not in hlo:
        raise AssertionError(f"{KERNEL_NAME} not in the compiled refresh")
    print(f"  {KERNEL_NAME} found in the compiled refresh")
    for nlev in nlevs:
        args = jax.device_put(sweep_inputs(ncol, nlev), dev)
        ref = jax.jit(lambda *a: rtrnmc(*a, dudts=True))
        ker = jax.jit(lambda *a: rtrnmc_triton(*a, dudts=True))
        want, got = to_host(ref(*args)), to_host(ker(*args))
        for name in sorted(want):
            check_close(f"{nlev} lev {name}", got[name], want[name], 1e-5,
                        reason="sum order over g; exp rounding")
        for fn, label in ((ref, "jnp scan"), (ker, "kernel"),
                          (ker, "kernel"), (ref, "jnp scan")):
            t0 = time.perf_counter()
            for _ in range(5):
                jax.block_until_ready(fn(*args))
            print(f"  {ncol}x{nlev} rtrnmc alone, {label}: "
                  f"{1e3 * (time.perf_counter() - t0) / 5:.2f} ms")

    # the refresh with the jnp sweep in place of the kernel
    inp = jax.device_put(inp_h, dev)
    swap = lwmod.rtrnmc_for_platform
    lwmod.rtrnmc_for_platform = rtrnmc
    jax.clear_caches()
    try:
        compiled_scan, t_comp = compile_refresh(inp, kw, *times[0])
    finally:
        lwmod.rtrnmc_for_platform = swap
        jax.clear_caches()
    if KERNEL_NAME in compiled_scan.as_text():
        raise AssertionError("jnp-sweep refresh still calls the kernel")
    print(f"  refresh with the jnp sweep compiled in {t_comp:.1f} s")
    a = to_host(run_hour(inp, kw, *times[0], refresh=compiled_kernel))
    b = to_host(run_hour(inp, kw, *times[0], refresh=compiled_scan))
    check_close("refresh LW net flux, kernel vs scan", a[1].flx, b[1].flx,
                1e-5, reason="sum order over g; exp rounding")
    res = {}
    for fn, label in ((compiled_kernel, "kernel"), (compiled_scan, "scan"),
                      (compiled_scan, "scan"), (compiled_kernel, "kernel")):
        dt = timed_hours(inp, kw, times, refresh=fn)
        res.setdefault(label, []).append(dt)
        print(f"  refresh hour with the {label}: {1e3 * dt:.2f} ms")
    print("  mean: kernel {:.2f} ms, scan {:.2f} ms per refresh hour".format(
        *(1e3 * np.mean(res[k]) for k in ("kernel", "scan"))))


def sweep_inputs(ncol, nlev, seed=3):
    """Host rtrnmc inputs built by the LW pipeline from the scene."""
    import jax
    import jax.numpy as jnp
    from geosradiation_gridcomp.models.rrtmg import lw as lwmod
    from geosradiation_gridcomp.models.rrtmg.cldprmc_lw import cldprmc_lw
    from geosradiation_gridcomp.models.rrtmg.setcoef_lw import setcoef_lw
    from geosradiation_gridcomp.models.rrtmg.taumol_lw import taumol_lw
    from geosradiation_gridcomp.ops.mcica import generate_stochastic_clouds

    inp, _ = scene(ncol, nlev, seed)

    @jax.jit
    def build(inp):
        play = 0.005 * (inp.ple[:, 1:] + inp.ple[:, :-1])
        plev = inp.ple * 0.01
        tlev = lwmod.level_temperatures(play, inp.t, plev, inp.ts)
        emis = jnp.broadcast_to(inp.emis[:, None], (ncol, 16))
        h2o = inp.qv / (1.0 - inp.qv) * (28.964 / 18.015)
        o3 = inp.o3 * (28.964 / 47.998)
        c = lambda v: jnp.full_like(play, v)
        coefs = setcoef_lw(play, inp.t, plev, tlev, inp.ts, emis, h2o, o3,
                           c(4.1e-4), c(1.8e-6), c(3.2e-7), c(0.209),
                           c(1.5e-7), c(2.3e-10), c(5.2e-10), c(2.4e-10),
                           c(8e-11))
        zm = lwmod.mid_heights(play, inp.t, inp.ple[:, -1])
        dp = inp.ple[:, 1:] - inp.ple[:, :-1]
        cldy, ciwp, clwp = generate_stochastic_clouds(
            zm, inp.lats, 172.0, play, inp.fcld,
            1000.0 * inp.qi * dp / 9.80665, 1000.0 * inp.ql * dp / 9.80665,
            1e-20, nsubcol=140)
        taucmc, cloudy = cldprmc_lw(cldy, ciwp, clwp, inp.ri, inp.rl)
        taug, pfracs = taumol_lw(coefs)
        return (emis, taug, pfracs, cloudy, jnp.swapaxes(taucmc, -1, -2),
                coefs.planklay, coefs.planklev, coefs.plankbnd,
                coefs.dplankbnd_dts, coefs.pwvcm)

    return to_host(build(inp))


_COLLECTIVE = re.compile(r"\b(all-gather|all-reduce|all-to-all|"
                         r"collective-permute|reduce-scatter)(-start)?\(")


_OP_NAME = re.compile(r'op_name="([^"]*)"')


def count_collectives(hlo_text, by_source=False):
    """{op: count} of collective instructions in compiled HLO text, or
    with by_source {(op, source op_name): count}."""
    counts = {}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE.search(line)
        if m:
            src = _OP_NAME.search(line)
            key = ((m.group(1), src.group(1) if src else "?") if by_source
                   else m.group(1))
            counts[key] = counts.get(key, 0) + 1
    return counts


def mesh_phase(devs, ncol_per=NCOL, nlev=NLEV, times=TIMES[:1]):
    """The refresh + updates sharded over a column mesh of `devs`,
    against single-device runs of each shard's columns on devs[0]."""
    import jax
    from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                    radiation_update)
    from geosradiation_gridcomp.parallel.sharding import (column_mesh,
                                                          shard_columns)

    n = len(devs)
    print(f"[6] column mesh over {n} {devs[0].device_kind}: {ncol_per} "
          f"columns x {nlev} levels per device, no daylight packing")
    inp_h, kw = scene(n * ncol_per, nlev)
    cfg = kw["config"]
    inp = shard_columns(column_mesh(devs), inp_h)
    doy, utc = times[0]
    t0 = time.perf_counter()
    lowered = radiation_refresh.lower(inp, doy, utc, **kw)
    compiled = lowered.compile()
    print(f"  sharded refresh compile {time.perf_counter() - t0:.1f} s")
    sol, irr = compiled(inp, doy, utc)
    upd = radiation_update.lower(sol, irr, inp.tsinst, inp.lons, inp.lats,
                                 inp.ple, doy, utc, config=cfg).compile()
    for name, c in (("refresh", compiled), ("update", upd)):
        print(f"  collectives in the compiled {name}: "
              f"{count_collectives(c.as_text()) or 'none'}")
        for (op, src), k in sorted(count_collectives(
                c.as_text(), by_source=True).items()):
            print(f"    {k} x {op} from {src}")
    t0 = time.perf_counter()
    got = to_host(run_hour(inp, kw, doy, utc))
    print(f"  sharded hour (compiled above; update may compile): "
          f"{time.perf_counter() - t0:.1f} s")
    check_physics(*got, f"mesh {n}x{ncol_per}")
    for i in range(n):
        cols = slice(i * ncol_per, (i + 1) * ncol_per)
        sub = jax.tree.map(lambda x: x[cols], inp_h)
        want = to_host(run_hour(jax.device_put(sub, devs[0]), kw, doy, utc))
        mine = jax.tree.map(lambda x: x[cols], got)
        print(f"  shard {i} against one device:")
        why = "same code; the partitioned compile may round differently"
        check_close("LW net flux", mine[1].flx, want[1].flx, 1e-3, 0.005,
                    why)
        check_close("SW net flux", mine[0].flxn, want[0].flxn, 1e-3,
                    0.005, why)
        check_heating(mine[2], want[2], sub.ple, 1e-3, 0.005)


# --------------------------------------------------------------------- main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-GPU column-mesh phase")
    args = ap.parse_args()

    import jax
    t_start = time.perf_counter()
    devs = device_phase(args.devices)
    if args.devices == 4:
        mesh_phase(devs)
    else:
        dev, cpu = devs[0], jax.devices("cpu")[0]
        inp_h, kw, first, compiled = main_path_phase(dev)
        deep_phase(dev)
        reference_phase(dev, cpu, inp_h, kw, first)
        scheme_phase(dev, cpu)
        kernel_phase(dev, compiled, inp_h, kw)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
