"""ISCCP cloud simulator (icarus).

Re-derivation of the reference's icarus.f:1-1273 in JAX: every loop over
(points, subcolumns) is vectorized; the TOA radiance accumulations become
exclusive cumulative products over the level axis; the brightness-
temperature/pressure level match becomes a masked arg-reduction instead
of a serial search. The 10.5-micron water-vapor continuum follows
Schwarzkopf & Ramaswamy (icarus.f:125 block), the partially-transmitting
cloud-top adjustment and the tau/CTP histogram match the ISCCP D-series
documentation as coded in the reference.

All level arrays are TOA-first ([..., 0] = top), like the reference.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# ISCCP 7x7 histogram bin edges (icarus.f:995-1046)
TAU_EDGES = np.array([0.3, 1.3, 3.6, 9.4, 23.0, 60.0])    # itau 1..7
PTOP_EDGES = np.array([180., 310., 440., 560., 680., 800.])  # ipres (mb)
ISCCP_TAUMIN = 0.3
MISSING = -1.0e30
_TAUCHK = -np.log(0.9999999)
_B0 = 1307.27          # Planck exponent at 10.5 micron (icarus radiances)


def _bb(t):
    """Normalized 10.5-micron Planck radiance (icarus.f bb)."""
    return 1.0 / jnp.expm1(_B0 / t)


def _inv_bb(f):
    """Brightness temperature from normalized radiance."""
    return _B0 / jnp.log1p(1.0 / jnp.maximum(f, 1e-30))


def water_vapor_emissivity(pfull, phalf, qv, at):
    """10.5-micron water-vapor continuum emissivity per layer
    (icarus.f clear-sky block; Schwarzkopf & Ramaswamy JGR 1999)."""
    wtmair, wtmh20 = 28.9644, 18.01534
    navo, grav = 6.023e23, 9.806650e2
    pstd, t0 = 1.013250e6, 296.0
    press = pfull * 10.0                      # dyne/cm^2
    dpress = (phalf[..., 1:] - phalf[..., :-1]) * 10.0
    atmden = dpress / grav
    rvh20 = qv * wtmair / wtmh20
    wk = rvh20 * navo * atmden / wtmair
    rhoave = (press / pstd) * (t0 / at)
    rh20s = rvh20 * rhoave
    rfrgn = rhoave - rh20s
    tmpexp = jnp.exp(-0.02 * (at - t0))
    tauwv = wk * 1e-20 * (0.0224697 * rh20s * tmpexp
                          + 3.41817e-7 * rfrgn) * 0.98
    return -jnp.expm1(-tauwv)


def _toa_radiance(dem, bb, sfc_bb, emsfc):
    """TOA 10.5-micron radiance from per-layer emissivities.

    fluxtop = sum_l dem_l * bb_l * prod_{k<l}(1-dem_k)
            + emsfc * bb_sfc * prod_all(1-dem).
    dem/bb: [..., nlev]; returns [...]."""
    trans = jnp.cumprod(1.0 - dem, axis=-1)
    trans_above = jnp.concatenate(
        [jnp.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    return (jnp.sum(dem * bb * trans_above, axis=-1)
            + emsfc * sfc_bb * trans[..., -1])


@partial(jax.jit, static_argnames=("top_height", "top_height_direction"))
def isccp_simulator(frac_out, pfull, phalf, qv, at, skt, emsfc_lw,
                    dtau_s, dtau_c, dem_s, dem_c, sunlit,
                    top_height=1, top_height_direction=2):
    """ISCCP cloud-type diagnostics from sampled subcolumns.

    Args:
      frac_out: [np, ncol, nlev] int (0/1/2) from scops.
      pfull/at/qv/dtau_*/dem_*: [np, nlev]; phalf: [np, nlev+1] (Pa).
      skt: [np] skin temperature; emsfc_lw: scalar surface emissivity.
      sunlit: [np] 1/0.
      top_height: 1 = VIS/IR adjusted ptop, 2 = model ptop, 3 = IR-only.
      top_height_direction: 1 lowest / 2 highest altitude temperature
        match (icarus.f:104-123).

    Returns dict: fq_isccp [np, 7, 7] (tau x ptop), totalcldarea,
    meanptop, meantaucld, meanalbedocld, meantb, meantbclr [np],
    boxtau/boxptop [np, ncol].
    """
    npnt, ncol, nlev = frac_out.shape
    dtype = pfull.dtype
    adjust = top_height in (1, 3)

    # per-subcolumn visible optical depth (icarus.f tau accumulation)
    tau = jnp.sum(jnp.where(frac_out == 1, dtau_s[:, None, :], 0.0)
                  + jnp.where(frac_out == 2, dtau_c[:, None, :], 0.0),
                  axis=-1)

    if adjust:
        # tropopause: min temperature in 50-400 hPa (icarus.f:12 loop)
        in_trop = (pfull < 40000.0) & (pfull > 5000.0)
        at_masked = jnp.where(in_trop, at, 400.0)
        itrop = jnp.argmin(at_masked, axis=-1)
        has_trop = in_trop.any(axis=-1)
        attrop = jnp.where(has_trop, jnp.min(at_masked, axis=-1), 120.0)
        ptrop = jnp.where(
            has_trop, jnp.take_along_axis(pfull, itrop[:, None],
                                          -1)[:, 0], 5000.0)
        lev_idx = jnp.arange(nlev)[None, :]
        atmax = jnp.max(jnp.where(lev_idx >= itrop[:, None], at, 0.0),
                        axis=-1)

        dem_wv = water_vapor_emissivity(pfull, phalf, qv, at)
        bb_lay = _bb(at)
        bb_sfc = _bb(skt)
        flux_clr = _toa_radiance(dem_wv, bb_lay, bb_sfc, emsfc_lw)
        meantbclr = _inv_bb(flux_clr)

        # all-sky per-subcolumn radiance: combined cloud+wv emissivity
        demwv_x = dem_wv[:, None, :]
        dem = jnp.where(
            frac_out == 1,
            1.0 - (1.0 - demwv_x) * (1.0 - dem_s[:, None, :]),
            jnp.where(frac_out == 2,
                      1.0 - (1.0 - demwv_x) * (1.0 - dem_c[:, None, :]),
                      demwv_x))
        fluxtop = _toa_radiance(dem, bb_lay[:, None, :], bb_sfc[:, None],
                                emsfc_lw)
        meantb = _inv_bb(fluxtop).mean(axis=-1)

        # partially-transmitting cloud adjustment (icarus.f:~700 block)
        btcmin = _bb(attrop - 5.0)[:, None]
        transmax = jnp.where(
            flux_clr[:, None] != btcmin,
            (fluxtop - btcmin) / (flux_clr[:, None] - btcmin), 1.0)
        tauir = tau / 2.13
        taumin = -jnp.log(jnp.clip(transmax, 0.001, 0.9999999))
        if top_height == 1:
            in_range = (transmax > 0.001) & (transmax <= 0.9999999)
            fluxtopinit = fluxtop
            ftop = fluxtop
            for _ in range(2):       # two fixed-point cycles (icycle)
                emcld = -jnp.expm1(-tauir)
                fnew = fluxtopinit - (1.0 - emcld) * flux_clr[:, None]
                fnew = jnp.maximum(1e-6, fnew / jnp.maximum(emcld, 1e-12))
                apply = (tau > _TAUCHK) & in_range
                ftop = jnp.where(apply, fnew, ftop)
                tb_i = _inv_bb(ftop)
                tauir = jnp.where(apply & (tb_i > 260.0), tau / 2.56,
                                  tauir)
            fluxtop = ftop
        tb = jnp.where(tau > _TAUCHK, _inv_bb(fluxtop),
                       meantbclr[:, None])
        if top_height == 1:
            frozen = tauir < taumin
            tb = jnp.where((tau > _TAUCHK) & frozen,
                           (attrop - 5.0)[:, None], tb)
            tau = jnp.where((tau > _TAUCHK) & frozen, 2.13 * taumin, tau)

        # level whose temperature matches tb, at/below the tropopause
        # (icarus.f "30" loop): bracket tests on consecutive levels
        at1 = at[:, None, :-1]         # [np, 1, nlev-1]
        at2 = at[:, None, 1:]
        tbx = tb[..., None]
        bracket = (((at1 >= tbx) & (at2 <= tbx))
                   | ((at1 <= tbx) & (at2 >= tbx)))
        k_idx = jnp.arange(nlev - 1)[None, None, :]
        bracket = bracket & (k_idx >= itrop[:, None, None])
        has_match = bracket.any(axis=-1)
        if top_height_direction == 2:
            # last match scanning upward = lowest k (highest altitude)
            kmatch = jnp.argmax(bracket, axis=-1)
        else:
            kmatch = (nlev - 2) - jnp.argmax(bracket[..., ::-1], axis=-1)
        km = kmatch[..., None]
        p1 = jnp.take_along_axis(pfull[:, None, :], km, axis=-1)
        p2 = jnp.take_along_axis(pfull[:, None, :], km + 1, axis=-1)
        t1 = jnp.take_along_axis(at[:, None, :], km, axis=-1)
        t2 = jnp.take_along_axis(at[:, None, :], km + 1, axis=-1)
        atd = jnp.maximum(_TAUCHK, jnp.abs(t2 - t1))
        logp = jnp.log(p1) + (jnp.log(p2) - jnp.log(p1)) \
            * jnp.abs(tbx - t1) / atd
        ptop_m = jnp.exp(logp)[..., 0]
        ptop = jnp.where(
            has_match, ptop_m,
            jnp.where(tb <= attrop[:, None], ptrop[:, None],
                      jnp.where(tb >= atmax[:, None],
                                pfull[:, -1:], 0.0)))
    else:
        # top_height == 2: model cloud-top pressure = highest cloudy level
        cloudy_lev = frac_out != 0
        first = jnp.argmax(cloudy_lev, axis=-1)
        anyc = cloudy_lev.any(axis=-1)
        ptop = jnp.where(
            anyc,
            jnp.take_along_axis(phalf[:, None, :], first[..., None],
                                axis=-1)[..., 0],
            0.0)
        meantb = jnp.full((npnt,), MISSING, dtype)
        meantbclr = jnp.full((npnt,), MISSING, dtype)

    ptop = jnp.where(tau <= _TAUCHK, 0.0, ptop)
    box_cloudy = (tau > _TAUCHK) & (ptop > 0.0)
    ptop_mb = ptop / 100.0

    # visibility of diagnostics: daytime only unless IR-only mode
    seen = (sunlit == 1) if top_height != 3 \
        else jnp.ones((npnt,), bool)
    boxarea = 1.0 / ncol

    thick = box_cloudy & (tau >= ISCCP_TAUMIN)
    albedocld = jnp.where(
        thick, tau ** 0.895 / (tau ** 0.895 + 6.82), 0.0)
    totalcldarea = jnp.sum(thick, axis=-1) * boxarea
    meanalbedocld = jnp.sum(albedocld, axis=-1) * boxarea
    meanptop = jnp.sum(jnp.where(thick, ptop_mb, 0.0), axis=-1) * boxarea

    # 7x7 joint histogram: itau x ipres one-hot accumulation
    itau = jnp.digitize(tau, jnp.asarray(TAU_EDGES))          # 0..6
    ipres = jnp.digitize(ptop_mb, jnp.asarray(PTOP_EDGES))    # 0..6
    cell = itau * 7 + ipres
    onehot = (cell[..., None] == jnp.arange(49)[None, None, :])
    fq = jnp.sum(jnp.where(box_cloudy[..., None], onehot, False),
                 axis=1) * boxarea
    fq_isccp = fq.reshape(npnt, 7, 7)

    # in-cloud means (only over tau >= taumin area)
    pos = totalcldarea > 0.0
    meanptop = jnp.where(pos, meanptop / jnp.maximum(totalcldarea, 1e-12),
                         MISSING)
    meanalb = jnp.where(pos,
                        meanalbedocld / jnp.maximum(totalcldarea, 1e-12),
                        MISSING)
    meantaucld = jnp.where(
        pos, (6.82 / (1.0 / jnp.clip(meanalb, 1e-6, 1 - 1e-6) - 1.0))
        ** (1.0 / 0.895), MISSING)

    mask1 = lambda x: jnp.where(seen, x, MISSING)
    maskh = jnp.where(seen[:, None, None], fq_isccp, MISSING)
    return dict(
        fq_isccp=maskh,
        totalcldarea=mask1(totalcldarea),
        meanptop=mask1(meanptop), meantaucld=mask1(meantaucld),
        meanalbedocld=mask1(meanalb),
        meantb=mask1(meantb) if adjust else meantb,
        meantbclr=mask1(meantbclr) if adjust else meantbclr,
        boxtau=jnp.where(box_cloudy, tau, MISSING),
        boxptop=jnp.where(box_cloudy, ptop_mb, MISSING))
