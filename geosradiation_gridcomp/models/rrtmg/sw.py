"""RRTMG-SW all-sky McICA driver (the reference's rrtmg_sw / rrtmg_sw_sub).

Pipeline per rrtmg_sw_rad.F90:455-1763: stochastic subcolumns (SW seed
order reversed vs LW, :1402), SW cloud optics with delta scaling, setcoef,
then spcvmc (taumol + two-stream + adding) for clear and all-sky fluxes.

The reference's clear/cloudy gridcolumn partitioning (:1130-1204) is an
MPI-era optimization; here the full batch computes both streams (the
clear-sky pass is shared inside spcvmc), and XLA/the mesh handle tiling.

All inputs TOA-first. scon: solar constant (W/m^2). Solar-cycle
variability: isolvar modes -1..3 per NRLSSI2 (nrlssi2.py), folded into
the solar-source tables as static per-band weights.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ...ops.mcica import generate_stochastic_clouds, clear_counts_three_band
from .cldprmc_sw import cldprmc_sw
from .nrlssi2 import solar_source_weights
from .setcoef_sw import setcoef_sw
from .spcvmc import spcvmc_sw
from .taumol_sw import taumol_sw
from .tables_sw import NGPTSW

RRSW_SCON = 1368.22    # internal solar constant of the k-tables (rrsw_con)


@partial(jax.jit, static_argnames=("iceflag", "liqflag", "cloud_mh",
                                   "cloud_lm", "inhm", "scon", "isolvar",
                                   "solcycfrac", "indsolvar", "bndscl",
                                   "nlit", "ncld"))
def rrtmg_sw(ple, play, tlay, coszen, albdir_uv, albdif_uv,
             albdir_nir, albdif_nir,
             h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
             cldf, ciwp, clwp, rei, rel, zm, alat, doy,
             taua=None, ssaa=None, asya=None,
             adjes=1.0, *, scon=1361.0,
             isolvar=-1, solcycfrac=None, indsolvar=None, bndscl=None,
             iceflag=3, liqflag=1, cloud_mh=1, cloud_lm=2, inhm=1,
             nlit=None, ncld=None):
    """RRTMG SW fluxes with McICA clouds.

    Args (TOA-first):
      ple [ncol, nlay+1] Pa; play [ncol, nlay] hPa; tlay [K]
      coszen [ncol]; albedos [ncol] (UV/vis and NIR, direct/diffuse)
      gas vmrs [ncol, nlay]
      cldf, ciwp, clwp (in-cloud g/m^2), rei, rel, zm, alat, doy: as in LW
      taua/ssaa/asya: optional [ncol, nlay, 14] aerosol optics
      scon: solar constant (0 = scheme-internal); adjes: Earth-Sun factor
      isolvar/solcycfrac/indsolvar/bndscl: NRLSSI2 solar variability
        (rrtmg_sw_rad.F90:968-1112); static config, all modes -1..3
      nlit: STATIC upper bound on the number of lit (coszen > 0)
        columns, or None to compute every column. When given, columns
        are sorted day-cloudy / day-clear / night and only the first
        nlit run the SW pipeline - the equivalent of the
        reference's daylight packing (NumLit + PackIt/UnPackIt,
        GEOS_SolarGridComp.F90:3684-3687, 7753-7799): compaction by
        sort + static slice instead of dynamic gather, scatter-back of
        exact zeros for night columns. The caller must guarantee
        nlit >= the actual lit count (bucketed counts keep the set of
        compiled shapes small); lit columns beyond nlit would be
        silently zeroed.
      ncld: STATIC upper bound on the number of CLOUDY columns, or None.
        The sort puts cloudy columns first, so the McICA-cloudy
        two-stream pass in spcvmc runs only on the first ncld columns
        and the all-sky outputs of the clear remainder alias the
        clear-sky solve (exactly what the cloudy pass computes for
        them) - the solver half of the reference's clear/cloudy
        partitioning (rrtmg_sw_rad.F90:1130-1204). Same caller
        contract as nlit: must be >= the true cloudy count.

    Returns dict of [ncol, nlay+1] fluxes (W/m^2): bbfu/bbfd (all-sky
    up/down), bbcu/bbcd (clear), direct components, UV/NIR band profiles,
    surface band fluxes, clear_counts (lit columns only under nlit;
    skipped columns read fully clear).
    """
    # day-cloudy / day-clear / night column sort: per-column physics
    # (and the per-column McICA seeds, derived from play) is
    # order-invariant, so the sort only decides which columns the static
    # nlit / ncld slices cover; outputs are unpermuted below.
    ncol_full = cldf.shape[0]
    if nlit is not None and nlit >= ncol_full:
        nlit = None
    sort_cols = nlit is not None or ncld is not None
    if sort_cols:
        clearcol = jnp.logical_not((cldf > 0.0).any(axis=1))
        if nlit is None:
            key = clearcol
        else:
            key = 2 * (coszen <= 0.0).astype(jnp.int32) \
                + clearcol.astype(jnp.int32)
        perm = jnp.argsort(key, stable=True)
        inv = jnp.argsort(perm)
        pc = lambda x: (None if x is None
                        else x[perm] if nlit is None else x[perm][:nlit])
        (ple, play, tlay, coszen, albdir_uv, albdif_uv, albdir_nir,
         albdif_nir, h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr, cldf, ciwp,
         clwp, rei, rel, zm, alat, taua, ssaa, asya) = map(
            pc, (ple, play, tlay, coszen, albdir_uv, albdif_uv,
                 albdir_nir, albdif_nir, h2ovmr, o3vmr, co2vmr, ch4vmr,
                 o2vmr, cldf, ciwp, clwp, rei, rel, zm, alat, taua,
                 ssaa, asya))

    plev = ple * 0.01

    scope = jax.named_scope
    with scope("sw.mcica"):
        cldy, ciwp_s, clwp_s = generate_stochastic_clouds(
            zm, alat, doy, play, cldf, ciwp, clwp, 1.0e-20,
            nsubcol=NGPTSW, inhm=inhm, seed_order=(3, 2, 1, 0))
        counts = clear_counts_three_band(cldy, cloud_mh, cloud_lm)

    with scope("sw.cldprmc"):
        taucmc_gl, ssacmc_gl, asmcmc_gl, _ = cldprmc_sw(
            cldy, ciwp_s, clwp_s, rei, rel, iceflag=iceflag,
            liqflag=liqflag)
        swap = lambda x: jnp.swapaxes(x, -1, -2)  # -> [ncol, nlay, ngpt]
        taucmc = swap(taucmc_gl)
        ssacmc = swap(ssacmc_gl)
        asmcmc = swap(asmcmc_gl)
        cldymc = swap(cldy)

    with scope("sw.setcoef"):
        coefs = setcoef_sw(play, tlay, plev, h2ovmr, o3vmr, co2vmr,
                           ch4vmr, o2vmr)
    svw = solar_source_weights(isolvar, scon, solcycfrac, indsolvar,
                               bndscl)
    with scope("sw.taumol"):
        taug, taur, sfluxzen = taumol_sw(coefs, svw)

    # band albedo vectors: bands 10-13 (UV/vis) use UV albedo; 14 and 1-9
    # NIR; band 9 is split in the reference's aggregation but albedo uses
    # NIR (GEOS_SolarGridComp passes band-9 via NIR albedos)
    import numpy as np
    ibm = np.arange(1, 15)
    uvband = (ibm >= 10) & (ibm <= 13)
    albdir = jnp.where(jnp.asarray(uvband), albdir_uv[:, None],
                       albdir_nir[:, None])
    albdif = jnp.where(jnp.asarray(uvband), albdif_uv[:, None],
                       albdif_nir[:, None])

    # scon / isolvar scaling is already folded into sfluxzen via svw
    with scope("sw.spcvmc"):
        out = spcvmc_sw(coefs, taug, taur, sfluxzen, coszen, albdir,
                        albdif, cldymc, taucmc, ssacmc, asmcmc,
                        taua=taua, ssaa=ssaa, asya=asya,
                        adjflux=adjes, ncld=ncld)
    out["clear_counts"] = counts
    # zero out fluxes for night columns
    day = (coszen > 0.0).astype(taug.dtype)
    for k, v in out.items():
        if k == "clear_counts":
            continue
        out[k] = v * day.reshape((-1,) + (1,) * (v.ndim - 1))
    if nlit is not None:
        # scatter back: exact zeros for skipped (night) columns
        # (UnPackIt, GEOS_SolarGridComp.F90:7776-7799); clear_counts of
        # skipped columns read fully clear (SW cloud diagnostics are
        # daytime-only, as in the reference's day-masked SORADCORE)
        pad = ncol_full - nlit
        def restore(v, fill):
            vp = jnp.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1),
                         constant_values=fill)
            return vp[inv]
        out = {k: restore(v, NGPTSW if k == "clear_counts" else 0)
               for k, v in out.items()}
    elif sort_cols:
        out = {k: v[inv] for k, v in out.items()}
    return out
