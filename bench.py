#!/usr/bin/env python
"""Benchmark: RRTMG SW+LW all-sky McICA refresh throughput on one GPU.

Prints one JSON line: columns/s per device on the north-star workload
(BASELINE.json config 3: all-sky SW+LW, McICA, 72 levels), with the
device it ran on. Refuses to run without a GPU, except for the explicit
BENCH_CPU_MESH rehearsal of --scaling.
"""

import json
import os
import time

import numpy as np


def device_info(allow_cpu=False):
    """{platform, kind, count} of the devices JAX runs on; raises unless
    they are GPUs or allow_cpu is set."""
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu" and not allow_cpu:
        raise RuntimeError(f"bench.py needs a GPU; JAX found {info}")
    print(f"# device: {info}")
    return info


def scaling_main():
    """Weak-scaling efficiency over a device mesh (BASELINE config 5
    harness). Fixed columns per device; reports columns/s and efficiency
    vs the 1-device rate at each mesh size. Runs on the GPUs of one host,
    or rehearses on a virtual CPU mesh with BENCH_CPU_MESH=<devices>."""
    if os.environ.get("BENCH_CPU_MESH"):
        n = os.environ["BENCH_CPU_MESH"]
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device"
                                     f"_count={n}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    from geosradiation_gridcomp.config import RadiationConfig
    from geosradiation_gridcomp.driver.step import radiation_refresh
    from geosradiation_gridcomp.parallel.sharding import (
        column_mesh, shard_columns)
    from __graft_entry__ import _example_inputs

    env = os.environ
    device = device_info(allow_cpu=bool(env.get("BENCH_CPU_MESH")))
    percol = int(env.get("BENCH_NCOL_PER_DEV", "256"))
    # weak scaling (fixed cols/device) is the real-hardware mode; on the
    # virtual CPU mesh the 8 "devices" share one core pool, so weak
    # scaling measures the host, not the sharding - use strong scaling
    # (fixed global cols; efficiency = throughput ratio, ~1.0 when
    # sharding adds no overhead) there.
    mode = env.get("BENCH_SCALING_MODE",
                   "strong" if jax.default_backend() == "cpu" else "weak")
    nlev = 72
    cfg = RadiationConfig()
    devs = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    base = None
    rows = []
    for n in sizes:
        mesh = column_mesh(devs[:n])
        ncol = percol * n if mode == "weak" else percol * sizes[-1]
        inp = _example_inputs(ncol=ncol, nlev=nlev)
        pmid = 0.5 * (np.asarray(inp.ple)[0, 1:]
                      + np.asarray(inp.ple)[0, :-1])
        ict, icb = cfg.superlayer_indices(pmid)
        inp = shard_columns(mesh, inp)
        step = lambda d: radiation_refresh(inp, d, 12.0, config=cfg,
                                           ict=ict, icb=icb)
        sol, irr = step(172.0)
        jax.block_until_ready((sol.flxn, irr.flx))
        n_iter = 5
        t0 = time.perf_counter()
        for i in range(n_iter):
            sol, irr = step(172.0 + i * 1e-3)
        jax.block_until_ready((sol.flxn, irr.flx))
        dt = (time.perf_counter() - t0) / n_iter
        cps = ncol / dt
        if base is None:
            base = cps
        # weak: fixed cols/device, ideal = n * base throughput.
        # strong: fixed global cols, ideal = base throughput scaled by n
        # devices -> eff = T1/(n*Tn) = cps/(base*n)... except on the
        # virtual CPU mesh, where the n "devices" share one core pool
        # and the honest statement is sharding overhead (cps/base ~ 1.0
        # when resharding adds nothing).
        if mode == "weak":
            eff = cps / (base * n)
        elif jax.default_backend() == "cpu":
            eff = cps / base
        else:
            eff = cps / (base * n)
        rows.append({"devices": n, "cols_per_s": round(cps, 1),
                     "efficiency": round(eff, 4)})
        print(f"# mesh={n:2d}  {cps:12.1f} cols/s  eff={eff:.3f}")
    metric = (f"{mode}_scaling_efficiency"
              if mode == "weak" or jax.default_backend() != "cpu"
              else "sharding_overhead_ratio")
    print(json.dumps({
        "metric": metric,
        "value": rows[-1]["efficiency"],
        "unit": "fraction", "device": device, "detail": rows}))


def staged_main():
    """BASELINE config 4 evidence: steady-state throughput with
    host->device input staging OVERLAPPED with compute (StagedFeed /
    run_steps_overlapped) vs the serial transfer->compute->block loop,
    streaming distinct host-resident batches through the full refresh."""
    import jax
    from geosradiation_gridcomp.config import RadiationConfig
    from geosradiation_gridcomp.driver.step import radiation_refresh
    from geosradiation_gridcomp.parallel.distributed import (
        run_steps_overlapped)
    from __graft_entry__ import _example_inputs

    device = device_info()
    env = os.environ
    ncol = int(env.get("BENCH_NCOL", "4096"))
    nbatch = int(env.get("BENCH_NBATCH", "8"))
    nlev = 72
    cfg = RadiationConfig()
    # distinct host-resident (numpy) batches: every step really stages
    # its inputs over PCIe; seeds differ so no transfer is elided
    batches = [jax.tree_util.tree_map(
        np.asarray, _example_inputs(ncol=ncol, nlev=nlev, seed=s))
        for s in range(nbatch)]
    pmid = 0.5 * (batches[0].ple[0, 1:] + batches[0].ple[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)

    def step(inp):
        return radiation_refresh(inp, 172.0, 12.0, config=cfg, ict=ict,
                                 icb=icb)

    # warmup / compile
    out = step(jax.device_put(batches[0]))
    jax.block_until_ready((out[0].flxn, out[1].flx))

    t0 = time.perf_counter()
    outs = run_steps_overlapped(step, batches)
    jax.block_until_ready([(s.flxn, i.flx) for s, i in outs])
    dt_ov = (time.perf_counter() - t0) / nbatch

    t0 = time.perf_counter()
    for b in batches:
        sol, irr = step(jax.device_put(b))
        jax.block_until_ready((sol.flxn, irr.flx))
    dt_serial = (time.perf_counter() - t0) / nbatch

    print(json.dumps({
        "metric": "staged_overlap_cols_per_s",
        "value": round(ncol / dt_ov, 1),
        "unit": "columns/s",
        "device": device,
        "serial_cols_per_s": round(ncol / dt_serial, 1),
        "overlap_speedup": round(dt_serial / dt_ov, 3),
        "workload": {"ncol": ncol, "nlev": nlev, "nbatch": nbatch}}))


def main():
    import jax
    from geosradiation_gridcomp.config import RadiationConfig
    from geosradiation_gridcomp.driver.step import (radiation_refresh,
                                                        sw_partition_bounds)
    from __graft_entry__ import _example_inputs

    device = device_info()
    env = os.environ
    ncol = int(env.get("BENCH_NCOL", "8192"))
    nlev = 72
    inp = _example_inputs(ncol=ncol, nlev=nlev)
    scene = env.get("BENCH_SCENE", "realistic")
    if scene == "overcast":
        # every column cloudy at every deck: the SW clear-column solver
        # split (sw_ncld) buys nothing; contrast with the default
        # realistic scene quantifies the clear-column exploitation
        # (rrtmg_sw_rad.F90:1130-1204's goal)
        import jax.numpy as jnp
        fcld = np.clip(np.asarray(inp.fcld) + 0.45, 0.45, 1.0)
        ql = np.maximum(np.asarray(inp.ql), 2e-5)
        qi = np.maximum(np.asarray(inp.qi), 5e-6)
        inp = inp._replace(fcld=jnp.asarray(fcld.astype(np.float32)),
                           ql=jnp.asarray(ql.astype(np.float32)),
                           qi=jnp.asarray(qi.astype(np.float32)))
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(inp.ple)[0, 1:] + np.asarray(inp.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    inp = jax.device_put(inp)

    # SW daylight packing + clear/cloudy solver split (NumLit,
    # GEOS_SolarGridComp.F90:3684-3687 / rrtmg_sw_rad.F90:1130-1204):
    # host-side bucketed bounds; max over the bench's doy range so the
    # bounds stay valid as the terminator drifts
    sw_nlit = sw_ncld = None
    if not env.get("BENCH_NO_DAYPACK"):
        bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d,
                                      12.0, cfg)
                  for d in (172.0, 172.01)]
        if not any(b[0] is None for b in bounds):
            sw_nlit = max(b[0] for b in bounds)
        if not any(b[1] is None for b in bounds):
            sw_ncld = max(b[1] for b in bounds)

    def step(doy):
        return radiation_refresh(inp, doy, 12.0, config=cfg, ict=ict,
                                 icb=icb, sw_nlit=sw_nlit,
                                 sw_ncld=sw_ncld)

    # warmup / compile
    sol, irr = step(172.0)
    jax.block_until_ready((sol.flxn, irr.flx))

    n_iter = 10
    t0 = time.perf_counter()
    for i in range(n_iter):
        sol, irr = step(172.0 + i * 1e-3)
    jax.block_until_ready((sol.flxn, irr.flx))
    dt = (time.perf_counter() - t0) / n_iter

    cols_per_s = ncol / dt
    fcld = np.asarray(inp.fcld)
    print(json.dumps({
        "metric": "columns_per_s_per_device_rrtmg_swlw_allsky",
        "value": round(cols_per_s, 1),
        "unit": "columns/s",
        "device": device,
        "xla_flags": env.get("XLA_FLAGS", ""),
        "workload": {
            "ncol": ncol, "nlev": nlev,
            "scene": scene,
            "cloudy_layer_fraction": round(float((fcld > 0).mean()), 3),
            "mean_cldfrac_in_cloudy": round(
                float(fcld[fcld > 0].mean()), 3),
            "day_night": "mixed (lons span 0..6 rad)",
            "sw_nlit": sw_nlit, "sw_ncld": sw_ncld},
    }))


if __name__ == "__main__":
    import sys

    from geosradiation_gridcomp.runtime import use_compile_cache
    if not os.environ.get("BENCH_CPU_MESH"):
        use_compile_cache()
    if "--scaling" in sys.argv:
        scaling_main()
    elif "--staged" in sys.argv:
        staged_main()
    else:
        main()
