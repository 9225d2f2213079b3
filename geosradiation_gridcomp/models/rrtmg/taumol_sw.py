"""RRTMG-SW gas/Rayleigh optical depths and solar source (taumol_sw).

Data-driven re-derivation of rrtmg_sw_taumol.F90:27-2086: per band 16..29,
2-species or 1-species key absorption (simple bilinear eta interpolation -
the SW scheme has no 0.125/0.875 ternary branch), water self/foreign
continuum, per-band extras (CH4/O3/CO2/H2O gray terms, O2 continuum), and
the solar source at a per-column reference layer (laysolfr) computed here
as a vectorized argmax over the jp profile instead of a serial search.

All arrays [ncol, nlay] TOA-first; outputs [ncol, nlay, 112] + sfluxzen
[ncol, 112].
"""

import jax.numpy as jnp
import numpy as np

from .tables_sw import (sw_tables, NG_SW, NSPA, NSPB, STRRAT, LAYREFFR,
                        SOLFR_LOWER, SOLFR_UPPER, NGPTSW)

_ONEMINUS = 1.0 - 1.0e-6


def _eta(col1, col2, strrat, mult):
    speccomb = col1 + strrat * col2
    specparm = jnp.minimum(col1 / speccomb, _ONEMINUS)
    specmult = mult * specparm
    js = 1 + jnp.floor(specmult).astype(jnp.int32)
    fs = specmult - jnp.floor(specmult)
    return speccomb, js, fs


def _interp_ind(tab, ind, frac):
    t0 = tab[ind - 1]
    return t0 + frac[..., None] * (tab[ind] - t0)


def _major2_full(tab, speccomb, js0, fs0, ind0, js1, fs1, ind1, c, estride):
    """Both (jp,jt) and (jp+1,jt1) contributions."""
    nmax = tab.shape[0] - 1

    def g(base, off):
        return tab[jnp.clip(base + off, 0, nmax)]
    fs0x = fs0[..., None]
    fs1x = fs1[..., None]
    f00 = c.fac00[..., None]
    f10 = c.fac10[..., None]
    f01 = c.fac01[..., None]
    f11 = c.fac11[..., None]
    return speccomb[..., None] * (
        (1 - fs0x) * f00 * g(ind0, 0) + fs0x * f00 * g(ind0, 1)
        + (1 - fs0x) * f10 * g(ind0, estride) + fs0x * f10 * g(ind0, estride + 1)
        + (1 - fs1x) * f01 * g(ind1, 0) + fs1x * f01 * g(ind1, 1)
        + (1 - fs1x) * f11 * g(ind1, estride) + fs1x * f11 * g(ind1, estride + 1))


def _major1(tab, colgas, ind0, ind1, c):
    nmax = tab.shape[0] - 1

    def g(i):
        return tab[jnp.clip(i, 0, nmax)]
    return colgas[..., None] * (
        c.fac00[..., None] * g(ind0) + c.fac10[..., None] * g(ind0 + 1)
        + c.fac01[..., None] * g(ind1) + c.fac11[..., None] * g(ind1 + 1))


def _selffor(c, selfref, forref, include_self=True):
    out = c.forfac[..., None] * _interp_ind(forref, c.indfor, c.forfrac)
    if include_self:
        out = out + c.selffac[..., None] * _interp_ind(
            selfref, c.indself, c.selffrac)
    return out


def _laysolfr(c, band):
    """Per-column solar reference layer index (TOA-first, 0-based)."""
    L = LAYREFFR[band]
    nlay = c.jp.shape[-1]
    idx = jnp.arange(nlay)
    if band in SOLFR_UPPER:
        cand = c.jp >= L
        has = jnp.any(cand, axis=-1)
        kmax = jnp.max(jnp.where(cand, idx, -1), axis=-1)
        return jnp.where(has, kmax, 0)
    else:
        # lower-reference: lowest layer with jp >= L, clamped into the
        # lower-atmosphere region; default = topmost lower layer
        cand = c.jp >= L
        has = jnp.any(cand, axis=-1)
        kmax = jnp.max(jnp.where(cand, idx, -1), axis=-1)
        k_trop = jnp.argmax(c.lower.astype(jnp.int32), axis=-1)
        return jnp.where(has, jnp.maximum(kmax, k_trop), k_trop)


def taumol_sw(c, svw=None):
    """Returns (taug, taur, sfluxzen): [ncol, nlay, 112] x2, [ncol, 112].

    svw: optional nrlssi2.SolarVarWeights. When given, the per-band solar
    source table becomes the static linear combination
    w_ref*sfluxref + w_fac*facbrght + w_sns*snsptdrk + w_irr*irradnce
    (the NRLSSI2 SSI decomposition folded at trace time - the isolvar
    branches of rrtmg_sw_taumol.F90 at zero runtime cost)."""
    t = sw_tables()
    taug_parts, taur_parts, sflux_parts = [], [], []
    low = c.lower[..., None]

    for band in range(16, 30):
        bi = band - 16
        tb = {k: jnp.asarray(v) for k, v in t[band].items()}
        if svw is not None:
            tb["sfluxref"] = jnp.asarray(
                svw.w_ref[bi] * t[band]["sfluxref"]
                + svw.w_fac[bi] * t[band]["facbrght"]
                + svw.w_sns[bi] * t[band]["snsptdrk"]
                + svw.w_irr[bi] * t[band]["irradnce"], jnp.float32)
        ng = NG_SW[bi]
        nspa = NSPA[bi]
        nspb = NSPB[bi]
        absa = tb.get("absa")
        absb = tb.get("absb")
        selfref = tb.get("selfref")
        forref = tb.get("forref")
        rayl = tb.get("rayl")

        i0b = ((c.jp - 1) * 5 + (c.jt - 1)) * nspa
        i1b = (c.jp * 5 + (c.jt1 - 1)) * nspa
        u0b = (jnp.maximum(c.jp - 13, 0) * 5 + (c.jt - 1)) * nspb
        u1b = (jnp.maximum(c.jp - 12, 1) * 5 + (c.jt1 - 1)) * nspb

        if rayl is not None and rayl.ndim == 0:
            taur = jnp.broadcast_to(
                (c.colmol * rayl)[..., None],
                c.colmol.shape + (ng,))
        elif rayl is not None:   # per-g rayl
            taur = c.colmol[..., None] * rayl
        else:
            taur = None

        if band == 16:
            sc, js, fs = _eta(c.colh2o, c.colch4, STRRAT[16], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref)
            thi = _major1(absb, c.colch4, u0b, u1b, c)
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band in (17, 21):
            sc, js, fs = _eta(c.colh2o, c.colco2, STRRAT[band], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref)
            scu, jsu, fsu = _eta(c.colh2o, c.colco2, STRRAT[band], 4.0)
            thi = _major2_full(absb, scu, jsu, fsu, u0b + jsu - 1,
                               jsu, fsu, u1b + jsu - 1, c, 5) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref,
                                                 include_self=False)
            sflux = _sflux_eta2(tb["sfluxref"], c, "h2o", "co2",
                                STRRAT[band], band)
        elif band == 18:
            sc, js, fs = _eta(c.colh2o, c.colch4, STRRAT[18], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref)
            thi = _major1(absb, c.colch4, u0b, u1b, c)
            sflux = _sflux_eta2(tb["sfluxref"], c, "h2o", "ch4",
                                STRRAT[18], band)
        elif band == 19:
            sc, js, fs = _eta(c.colh2o, c.colco2, STRRAT[19], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref)
            thi = _major1(absb, c.colco2, u0b, u1b, c)
            sflux = _sflux_eta2(tb["sfluxref"], c, "h2o", "co2",
                                STRRAT[19], band)
        elif band == 20:
            tlo = c.colh2o[..., None] * (
                c.fac00[..., None] * absa[i0b] + c.fac10[..., None] * absa[i0b + 1]
                + c.fac01[..., None] * absa[i1b] + c.fac11[..., None] * absa[i1b + 1]
                + _selffor(c, selfref, forref)) \
                + c.colch4[..., None] * tb["absch4"]
            nmaxb = absb.shape[0] - 1
            gb = lambda i: absb[jnp.clip(i, 0, nmaxb)]
            thi = c.colh2o[..., None] * (
                c.fac00[..., None] * gb(u0b) + c.fac10[..., None] * gb(u0b + 1)
                + c.fac01[..., None] * gb(u1b) + c.fac11[..., None] * gb(u1b + 1)
                + _selffor(c, selfref, forref, include_self=False)) \
                + c.colch4[..., None] * tb["absch4"]
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band == 22:
            o2adj = 1.6
            sc, js, fs = _eta(c.colh2o, c.colo2, o2adj * STRRAT[22], 8.0)
            o2cont = (4.35e-4 * c.colo2 / (350.0 * 2.0))[..., None]
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref) \
                + o2cont
            thi = (c.colo2 * o2adj)[..., None] * (
                c.fac00[..., None] * absb[jnp.clip(u0b, 0, absb.shape[0]-1)]
                + c.fac10[..., None] * absb[jnp.clip(u0b+1, 0, absb.shape[0]-1)]
                + c.fac01[..., None] * absb[jnp.clip(u1b, 0, absb.shape[0]-1)]
                + c.fac11[..., None] * absb[jnp.clip(u1b+1, 0, absb.shape[0]-1)]) \
                + o2cont
            sflux = _sflux_eta2(tb["sfluxref"], c, "h2o", "o2",
                                STRRAT[22], band, o2adj=o2adj)
        elif band == 23:
            givfac = 1.029
            tlo = c.colh2o[..., None] * (
                givfac * (c.fac00[..., None] * absa[i0b]
                          + c.fac10[..., None] * absa[i0b + 1]
                          + c.fac01[..., None] * absa[i1b]
                          + c.fac11[..., None] * absa[i1b + 1])
                + _selffor(c, selfref, forref))
            thi = jnp.zeros_like(tlo)
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band == 24:
            sc, js, fs = _eta(c.colh2o, c.colo2, STRRAT[24], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9) \
                + c.colh2o[..., None] * _selffor(c, selfref, forref) \
                + c.colo3[..., None] * tb["abso3a"]
            thi = _major1(absb, c.colo2, u0b, u1b, c) \
                + c.colo3[..., None] * tb["abso3b"]
            # per-g rayleigh: lower eta-interpolated rayla, upper raylb
            rayla = tb["rayla"]          # (9, ng)
            t0 = rayla[js - 1]
            t1 = rayla[jnp.clip(js, 0, rayla.shape[0] - 1)]
            taur_lo = c.colmol[..., None] * (t0 + fs[..., None] * (t1 - t0))
            taur_hi = c.colmol[..., None] * tb["raylb"]
            taur = jnp.where(low, taur_lo, taur_hi)
            sflux = _sflux_eta2(tb["sfluxref"], c, "h2o", "o2",
                                STRRAT[24], band)
        elif band == 25:
            tlo = c.colh2o[..., None] * (
                c.fac00[..., None] * absa[i0b] + c.fac10[..., None] * absa[i0b + 1]
                + c.fac01[..., None] * absa[i1b] + c.fac11[..., None] * absa[i1b + 1]) \
                + c.colo3[..., None] * tb["abso3a"]
            thi = c.colo3[..., None] * tb["abso3b"]
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band == 26:
            tlo = jnp.zeros(c.jp.shape + (ng,), c.colmol.dtype)
            thi = tlo
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band == 27:
            tlo = _major1(absa, c.colo3, i0b, i1b, c)
            thi = _major1(absb, c.colo3, u0b, u1b, c)
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))
        elif band == 28:
            sc, js, fs = _eta(c.colo3, c.colo2, STRRAT[28], 8.0)
            tlo = _major2_full(absa, sc, js, fs, i0b + js - 1,
                               js, fs, i1b + js - 1, c, 9)
            scu, jsu, fsu = _eta(c.colo3, c.colo2, STRRAT[28], 4.0)
            thi = _major2_full(absb, scu, jsu, fsu, u0b + jsu - 1,
                               jsu, fsu, u1b + jsu - 1, c, 5)
            sflux = _sflux_eta2(tb["sfluxref"], c, "o3", "o2",
                                STRRAT[28], band)
        elif band == 29:
            tlo = c.colh2o[..., None] * (
                c.fac00[..., None] * absa[i0b] + c.fac10[..., None] * absa[i0b + 1]
                + c.fac01[..., None] * absa[i1b] + c.fac11[..., None] * absa[i1b + 1]
                + _selffor(c, selfref, forref)) \
                + c.colco2[..., None] * tb["absco2"]
            thi = _major1(absb, c.colco2, u0b, u1b, c) \
                + c.colh2o[..., None] * tb["absh2o"]
            sflux = jnp.broadcast_to(tb["sfluxref"],
                                     c.jp.shape[:-1] + (ng,))

        taug_parts.append(jnp.where(low, tlo, thi))
        taur_parts.append(taur)
        sflux_parts.append(sflux)

    taug = jnp.concatenate(taug_parts, axis=-1)
    taur = jnp.concatenate(taur_parts, axis=-1)
    sfluxzen = jnp.concatenate(sflux_parts, axis=-1)
    return taug, taur, sfluxzen


def _sflux_eta2(tab, c, g1, g2, strrat, band, o2adj=1.0):
    """Eta-interpolated solar source at the per-column laysolfr layer."""
    k = _laysolfr(c, band)
    col1 = jnp.take_along_axis(getattr(c, "col" + g1), k[..., None],
                               axis=-1)[..., 0]
    col2 = jnp.take_along_axis(getattr(c, "col" + g2), k[..., None],
                               axis=-1)[..., 0]
    mult = 4.0 if band in SOLFR_UPPER else 8.0
    _, js, fs = _eta(col1, col2, o2adj * strrat, mult)
    nmax = tab.shape[0] - 1
    t0 = tab[js - 1]
    t1 = tab[jnp.clip(js, 0, nmax)]
    return t0 + fs[..., None] * (t1 - t0)


# ===========================================================================
# Gather-engine taumol_sw: 4 shared row-gathers for all 14 bands, mirroring
# the taumol_lw fast path (see taumol_lw.py's banner for the layout
# rationale: wide shared gathers, 128-aligned eta sections, per-band
# weights via static 0/1 segment matmuls, band assembly via scatter
# matmuls). The SW eta interpolation is a plain 2-point tent
# (no 0.125/0.875 ternary branch), so the weight construction is simpler
# than LW. The solar source (sfluxzen) stays in the per-column wrapper.
# ===========================================================================

import functools

import jax
from jax import lax

from .tables_sw import (sw_gather_tables, SW2_BANDS, SWS_BANDS, SW2_OFF,
                        SWS_OFF, SW_SPP, SW_NROW_LOWER, SW_NROWS, SW_PAIR,
                        SW_UPPER2, SW_UPPER1, SW_LOWER1)

taumol_sw_ref = taumol_sw     # keep the per-band engine as the test oracle


def _seg_dot(w_stack, seg):
    return lax.dot_general(
        w_stack, seg, (((w_stack.ndim - 1,), (0,)), ((), ())),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def _tent(js, fs, K):
    d = jnp.arange(K) - (js[..., None] - 1)
    return (jnp.where(d == 0, (1.0 - fs)[..., None], 0.0)
            + jnp.where(d == 1, fs[..., None], 0.0))


def _taumol_sw_gas(c):
    """Flat-cell gas + Rayleigh optical depth for all 112 g-points."""
    gt = sw_gather_tables()
    big = jnp.asarray(gt["big"])
    shape = c.jp.shape
    lower = c.lower
    low1 = lower[..., None]
    f32 = jnp.float32

    def col(gas):
        if gas == "o2x":
            return c.colo2 * 1.6
        return getattr(c, "col" + gas)

    # per-band eta weights, speccomb folded; regime-selected
    e9 = jnp.zeros(shape + (9,), f32)
    e0 = (jnp.arange(9) == 0).astype(f32)
    wsel = {}
    for b in SW2_BANDS:
        g1, g2, strrat = SW_PAIR[b]
        sc, js, fs = _eta(col(g1), col(g2), strrat, 8.0)
        wl = sc[..., None] * _tent(js, fs, 9)
        if b in SW_UPPER2:
            scu, jsu, fsu = _eta(col(g1), col(g2), strrat, 4.0)
            wu = scu[..., None] * _tent(jsu, fsu, 9)
        elif b in SW_UPPER1:
            wu = col(SW_UPPER1[b])[..., None] * e0
        else:
            wu = e9
        w = jnp.where(low1, wl, wu)
        wsel[b] = (w, w)      # SW: same eta weights for ind0 and ind1 rows

    jp = c.jp
    rbase0 = jnp.where(lower, 5 * (jp - 1),
                       SW_NROW_LOWER + 5 * jnp.clip(jp - 13, 0, 46)) \
        + c.jt - 1
    rbase1 = jnp.where(lower, 5 * jnp.clip(jp, 1, 13),
                       SW_NROW_LOWER + 5 * jnp.clip(jp - 12, 1, 46)) \
        + c.jt1 - 1
    G0 = big[jnp.clip(rbase0, 0, SW_NROWS - 1)]
    G1 = big[jnp.clip(rbase0 + 1, 0, SW_NROWS - 1)]
    G2 = big[jnp.clip(rbase1, 0, SW_NROWS - 1)]
    G3 = big[jnp.clip(rbase1 + 1, 0, SW_NROWS - 1)]

    f00 = c.fac00[..., None]
    f10 = c.fac10[..., None]
    f01 = c.fac01[..., None]
    f11 = c.fac11[..., None]
    seg2 = jnp.asarray(gt["seg_sw2"])

    acc2 = jnp.zeros(shape + (SW_SPP,), f32)
    for e in range(9):
        w = _seg_dot(jnp.stack([wsel[b][0][..., e] for b in SW2_BANDS],
                               axis=-1), seg2)
        sl = slice(e * SW_SPP, (e + 1) * SW_SPP)
        acc2 = acc2 + w * (f00 * G0[..., sl] + f10 * G1[..., sl]
                           + f01 * G2[..., sl] + f11 * G3[..., sl])

    ss_sl = slice(9 * SW_SPP, 10 * SW_SPP)
    colvec = _seg_dot(jnp.stack(
        [jnp.where(lower, col(SW_LOWER1[b]),
                   col(SW_UPPER1[b]) if b in SW_UPPER1
                   else jnp.zeros_like(c.colh2o))
         for b in SWS_BANDS], axis=-1), jnp.asarray(gt["seg_sws"]))
    acc_ss = colvec * (f00 * G0[..., ss_sl] + f10 * G1[..., ss_sl]
                       + f01 * G2[..., ss_sl] + f11 * G3[..., ss_sl])

    taug = _seg_dot(acc2, jnp.asarray(gt["scat_sw2"])) \
        + _seg_dot(acc_ss, jnp.asarray(gt["scat_sws"]))

    # colh2o-scaled self/foreign continua with per-band regime masks
    selfsum = c.selffac[..., None] * _onehot_sum_sw(
        gt["self10"], c.indself, c.selffrac, shape)
    forsum = c.forfac[..., None] * _onehot_sum_sw(
        gt["for4"], c.indfor, c.forfrac, shape)
    m_lo = jnp.asarray(gt["mask_self_lo"])
    m_hi = jnp.asarray(gt["mask_for_hi"])
    taug = taug + c.colh2o[..., None] * jnp.where(
        low1, (selfsum + forsum) * m_lo, forsum * m_hi)

    # gray absorbers + O2 continuum
    gray = gt["gray"]
    taug = taug + c.colch4[..., None] * jnp.asarray(gray["ch4_both"]) \
        + c.colo3[..., None] * jnp.where(low1, jnp.asarray(gray["o3_lo"]),
                                         jnp.asarray(gray["o3_hi"])) \
        + jnp.where(low1, c.colco2[..., None] * jnp.asarray(gray["co2_lo"]),
                    c.colh2o[..., None] * jnp.asarray(gray["h2o_hi"])) \
        + c.colo2[..., None] * jnp.asarray(gray["o2cont"])

    # Rayleigh: static per-g vector except band 24's eta-interpolated lower
    raylv = jnp.asarray(gt["raylvec"]) + (1.0 - lower.astype(f32))[..., None] \
        * jnp.asarray(gt["raylb24"])
    g1, g2, strrat = SW_PAIR[24]
    _, js24, fs24 = _eta(col(g1), col(g2), strrat, 8.0)
    w24 = _tent(js24, fs24, 9) * low1.astype(f32)
    r24 = _seg_dot(jnp.einsum("...e,eg->...g", w24,
                              jnp.asarray(gt["rayla24"]),
                              precision=lax.Precision.HIGHEST),
                   jnp.asarray(gt["scat_b24"]))
    taur = c.colmol[..., None] * (raylv + r24)
    return taug, taur


def _onehot_sum_sw(tab, ind, frac, shape):
    K = tab.shape[0]
    acc = jnp.zeros(shape + (tab.shape[1],), jnp.float32)
    i0 = ind - 1
    for k in range(K):
        w = jnp.where(i0 == k, 1.0 - frac, 0.0)
        if k >= 1:
            w = w + jnp.where(i0 == k - 1, frac, 0.0)
        acc = acc + w[..., None] * tab[k]
    return acc


def taumol_sw_fast(c, svw=None):
    """Fast-path taumol_sw: same contract as taumol_sw_ref."""
    ncol, nlay = c.jp.shape

    def fl(x):
        if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[:2] == (ncol, nlay):
            return x.reshape((ncol * nlay,) + x.shape[2:])
        return x

    cf = jax.tree_util.tree_map(fl, c)
    taug, taur = _taumol_sw_gas(cf)
    taug = taug.reshape(ncol, nlay, -1)
    taur = taur.reshape(ncol, nlay, -1)
    return taug, taur, sfluxzen_only(c, svw)


def sfluxzen_only(c, svw=None):
    """Solar source per column (cheap; needs the layer axis for
    laysolfr). [ncol, 112]."""
    t = sw_tables()
    sflux_parts = []
    for band in range(16, 30):
        bi = band - 16
        ng = NG_SW[bi]
        if svw is not None:
            sref = jnp.asarray(
                svw.w_ref[bi] * t[band]["sfluxref"]
                + svw.w_fac[bi] * t[band]["facbrght"]
                + svw.w_sns[bi] * t[band]["snsptdrk"]
                + svw.w_irr[bi] * t[band]["irradnce"], jnp.float32)
        else:
            sref = jnp.asarray(t[band]["sfluxref"])
        if band in (17, 21):
            sflux = _sflux_eta2(sref, c, "h2o", "co2", STRRAT[band], band)
        elif band == 18:
            sflux = _sflux_eta2(sref, c, "h2o", "ch4", STRRAT[18], band)
        elif band == 19:
            sflux = _sflux_eta2(sref, c, "h2o", "co2", STRRAT[19], band)
        elif band == 22:
            sflux = _sflux_eta2(sref, c, "h2o", "o2", STRRAT[22], band,
                                o2adj=1.6)
        elif band == 24:
            sflux = _sflux_eta2(sref, c, "h2o", "o2", STRRAT[24], band)
        elif band == 28:
            sflux = _sflux_eta2(sref, c, "o3", "o2", STRRAT[28], band)
        else:
            sflux = jnp.broadcast_to(sref, c.jp.shape[:-1] + (ng,))
        sflux_parts.append(sflux)
    return jnp.concatenate(sflux_parts, axis=-1)


taumol_sw = taumol_sw_fast
