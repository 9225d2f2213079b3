"""Chou-Suarez shortwave flux solver (JAX re-derivation of `sorad`).

Physics follows /root/reference/GEOSsolar_GridComp/sorad.F90:43-1588: 8 bands
(5 UV/PAR + 3 NIR x 10 water-vapor k-points), delta-Eddington two-stream layer
optics, the adding method over 8 maximally/randomly-overlapped sky conditions
(high/mid/low cloud groups), and O2/CO2 broadband flux reductions.

Restructuring for XLA:
* The 35 spectral points (5 UV + 30 NIR k-points) are a single vectorized
  axis; per-point constants (Rayleigh/ozone/water coefficients, band index)
  are gathered from static arrays instead of looping bands.
* All delta-Eddington calls (clear/cloudy x beam/diffuse x layers x spectral
  points) are one batched `deledd` evaluation.
* The adding sweeps (sorad.F90:1244-1315 CLDFLX) become three `lax.scan`s
  per direction over static layer ranges (high/mid/low regions), carrying the
  full (ih, im, is) = 2x2x2 sky-condition tensor in lanes; the reference's
  memory-saving asymmetric storage disappears.

Outputs are normalized: fraction of TOA insolation (multiply by
cosz * solar_constant for W/m^2), matching the reference convention.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.chou_optics import getvistau, getnirtau
from ..ops.twostream import deledd
from ..tables import load

_DSM = 0.602                       # cos(53 deg): diffuse-as-beam angle
_NS = 35                           # 5 UV + 3*10 NIR spectral points


def _spectral_constants():
    """Static per-spectral-point constant arrays (numpy, trace-time)."""
    t = load("chou_sorad_constants")
    wk = np.concatenate([t["wk_uv"], np.tile(t["xk_ir"], 3)])
    zk = np.concatenate([t["zk_uv"], np.zeros(30, np.float32)])
    ry = np.concatenate([t["ry_uv"], np.repeat(t["ry_ir"], 10)])
    band = np.concatenate([np.arange(5), np.repeat(np.arange(5, 8), 10)])
    optidx = np.concatenate([np.zeros(5, np.int64),
                             np.repeat(np.arange(1, 4), 10)])
    eps_ssa = np.concatenate([np.zeros(5, np.float32),
                              np.full(30, 1e-8, np.float32)])
    return wk, zk, ry, band.astype(np.int64), optidx, eps_ssa


def default_hk():
    """Default band k-weights (no solar-cycle file): hk_uv_old / hk_ir_old
    (GEOS_SolarGridComp.F90:3027-3028)."""
    t = load("chou_sorad_constants")
    return t["hk_uv_old"], t["hk_ir_old"]


def _expand(x, axis):
    """[ns, 2] layer property -> [ns, 2, 2, 2] along combo axis 1/2/3."""
    if axis == 1:
        return x[:, :, None, None]
    if axis == 2:
        return x[:, None, :, None]
    return x[:, None, None, :]


def _chou_sw_column(cosz, ple, ta, wa, oa, co2, cwc, fcld, reff,
                    taua, ssaa, asya, rsuvbm, rsuvdf, rsirbm, rsirdf,
                    hk_uv, hk_ir, *, ict, icb):
    dtype = ta.dtype
    np_ = ta.shape[0]
    cosz = jnp.maximum(cosz, 1e-4)
    snt = 1.0 / cosz

    pl = ple * 0.01                       # hPa
    dp = pl[1:] - pl[:-1]
    dp_pa = dp * 100.0
    pa = 0.5 * (pl[1:] + pl[:-1])

    # scaled water vapor / ozone amounts (sorad.F90:292-319)
    xtoa = jnp.maximum(pl[0], 1e-3)
    scal0 = xtoa * (0.5 * xtoa / 300.0) ** 0.8
    o3toa = 1.02 * oa[0] * xtoa * 466.7 + 1.0e-8
    wvtoa = 1.02 * wa[0] * scal0 * (1.0 + 0.00135 * (ta[0] - 240.0)) + 1.0e-9
    scal = dp * (pa / 300.0) ** 0.8
    wh = 1.02 * wa * scal * (1.0 + 0.00135 * (ta - 240.0)) + 1.0e-9
    oh = 1.02 * oa * dp * 466.7 + 1.0e-8
    swh = wvtoa + jnp.concatenate([jnp.zeros((1,), dtype),
                                   jnp.cumsum(wh)])     # levels 1..np+1

    # cloud optics for the 4 optics sets (UV + 3 NIR bands)
    tb_uv, tdf_uv, asy_uv = getvistau(cosz, dp_pa, fcld, reff, cwc,
                                      ict, icb, dtype)
    tb_nir, tdf_nir, asy_nir, ssa_nir = getnirtau(cosz, dp_pa, fcld, reff,
                                                  cwc, ict, icb, dtype)
    tauclb_os = jnp.concatenate([tb_uv.sum(-1)[None], tb_nir.sum(-1)], 0)
    tauclf_os = jnp.concatenate([tdf_uv.sum(-1)[None], tdf_nir.sum(-1)], 0)
    asycl_os = jnp.concatenate([asy_uv[None], asy_nir], 0)
    ssacl_os = jnp.concatenate([jnp.ones((1, np_), dtype), ssa_nir], 0)

    wk_s, zk_s, ry_s, band_s, optidx_s, eps_s = _spectral_constants()
    wk_s = jnp.asarray(wk_s, dtype)[:, None]
    zk_s = jnp.asarray(zk_s, dtype)[:, None]
    ry_s = jnp.asarray(ry_s, dtype)[:, None]
    eps_s = jnp.asarray(eps_s, dtype)[:, None]

    tauclb = tauclb_os[optidx_s]          # [ns, np]
    tauclf = tauclf_os[optidx_s]
    asycl = asycl_os[optidx_s]
    scl = ssacl_os[optidx_s]

    taua_s = taua.T[band_s]               # [ns, np]
    ssaa_s = ssaa.T[band_s]
    asya_s = asya.T[band_s]

    # clear-sky optical properties (Eqs. 6.2-6.4)
    taurs = ry_s * dp[None, :]
    tausto = taurs + zk_s * oh[None, :] + wk_s * wh[None, :] + taua_s + 1e-7
    ssatau = ssaa_s + taurs + eps_s
    asysto = asya_s

    ssatob_c = jnp.minimum(ssatau / tausto + 1e-8, 0.999999)
    asytob_c = asysto / ssatau
    rr1, tt1, td1 = deledd(tausto, ssatob_c, asytob_c, cosz)
    rs1, ts1, _ = deledd(tausto, ssatob_c, asytob_c, _DSM)

    # cloudy: beam and diffuse cloud optical depths scaled separately
    tautob = tausto + tauclb
    ssatob = jnp.minimum((ssatau + scl * tauclb) / tautob + 1e-8, 0.999999)
    asytob = (asysto + asycl * scl * tauclb) / (ssatob * tautob)
    tautof = tausto + tauclf
    ssatof = jnp.minimum((ssatau + scl * tauclf) / tautof + 1e-8, 0.999999)
    asytof = (asysto + asycl * scl * tauclf) / (ssatof * tautof)
    rr2, tt2, td2 = deledd(tautob, ssatob, asytob, cosz)
    rs2, ts2, _ = deledd(tautof, ssatof, asytof, _DSM)

    # layer property tensors [ns, np+2, 2]  (k=0 virtual TOA, np+1 surface)
    td0 = jnp.exp(-(wvtoa * wk_s[:, 0] + o3toa * zk_s[:, 0]) * snt)
    sfc_bm = jnp.where(jnp.asarray(band_s) < 5, rsuvbm, rsirbm)
    sfc_df = jnp.where(jnp.asarray(band_s) < 5, rsuvdf, rsirdf)

    def pack(top, lay1, lay2, sfc):
        a = jnp.stack([lay1, lay2], axis=-1)                 # [ns, np, 2]
        topx = jnp.broadcast_to(top[:, None, None], (_NS, 1, 2))
        sfcx = jnp.broadcast_to(sfc[:, None, None], (_NS, 1, 2))
        return jnp.concatenate([topx, a, sfcx], axis=1)      # [ns, np+2, 2]

    zero_s = jnp.zeros((_NS,), dtype)
    one_s = jnp.ones((_NS,), dtype)
    rr_l = pack(zero_s, rr1, rr2, sfc_bm)
    tt_l = pack(one_s, tt1, tt2, zero_s)
    td_l = pack(td0, td1, td2, zero_s)
    rs_l = pack(zero_s, rs1, rs2, sfc_df)
    ts_l = pack(one_s, ts1, ts2, zero_s)

    # ---- adding method ----
    def down_region(carry, ks, axis):
        def step(c, k):
            tda, tta, rsa = c
            rr_k = _expand(rr_l[:, k], axis)
            tt_k = _expand(tt_l[:, k], axis)
            td_k = _expand(td_l[:, k], axis)
            rs_k = _expand(rs_l[:, k], axis)
            ts_k = _expand(ts_l[:, k], axis)
            denm = ts_k / (1.0 - rsa * rs_k)
            tda_n = tda * td_k
            tta_n = tda * tt_k + (tda * rsa * rr_k + tta - tda) * denm
            rsa_n = rs_k + ts_k * rsa * denm
            return (tda_n, tta_n, rsa_n), (tda_n, tta_n, rsa_n)
        return lax.scan(step, carry, ks)

    shape = (_NS, 2, 2, 2)
    tda0 = jnp.broadcast_to(td_l[:, 0, 0][:, None, None, None], shape)
    tta0 = jnp.broadcast_to(tt_l[:, 0, 0][:, None, None, None], shape)
    rsa0 = jnp.broadcast_to(rs_l[:, 0, 0][:, None, None, None], shape)
    carry = (tda0, tta0, rsa0)
    ys = []
    for lo, hi, axis in ((1, ict, 1), (ict, icb, 2), (icb, np_ + 1, 3)):
        carry, y = down_region(carry, jnp.arange(lo, hi), axis)
        ys.append(y)
    tda_lev = jnp.concatenate([tda0[None]] + [y[0] for y in ys], 0)  # k=0..np
    tta_lev = jnp.concatenate([tta0[None]] + [y[1] for y in ys], 0)
    rsa_lev = jnp.concatenate([rsa0[None]] + [y[2] for y in ys], 0)

    def up_region(carry, ks, axis):
        def step(c, k):
            rra, rxa = c
            rr_k = _expand(rr_l[:, k], axis)
            tt_k = _expand(tt_l[:, k], axis)
            td_k = _expand(td_l[:, k], axis)
            rs_k = _expand(rs_l[:, k], axis)
            ts_k = _expand(ts_l[:, k], axis)
            denm = ts_k / (1.0 - rs_k * rxa)
            rra_n = rr_k + (td_k * rra + (tt_k - td_k) * rxa) * denm
            rxa_n = rs_k + ts_k * rxa * denm
            return (rra_n, rxa_n), (rra_n, rxa_n)
        return lax.scan(step, carry, ks)

    rra0 = jnp.broadcast_to(rr_l[:, -1, 0][:, None, None, None], shape)
    rxa0 = jnp.broadcast_to(rs_l[:, -1, 0][:, None, None, None], shape)
    carry = (rra0, rxa0)
    ys_up = []
    for lo, hi, axis in ((icb, np_ + 1, 3), (ict, icb, 2), (1, ict, 1)):
        # reversed ranges: np..icb, icb-1..ict, ict-1..1 (k=0 not needed)
        carry, y = up_region(carry, jnp.arange(hi - 1, lo - 1, -1), axis)
        ys_up.append(y)
    # ys_up entries are ordered k descending; build rra_lev for k=1..np+1
    rra_lev = jnp.concatenate(
        [jnp.concatenate([y[0][::-1] for y in ys_up[::-1]], 0), rra0[None]], 0)
    rxa_lev = jnp.concatenate(
        [jnp.concatenate([y[1][::-1] for y in ys_up[::-1]], 0), rxa0[None]], 0)
    # rra_lev[j] == rra at level k=j+1 for j=0..np

    # fluxes at levels k=1..np+1 (Eqs. 6.15-6.16); tda_lev[j] is the
    # composite through layer j (k-1 for level j+1), rra_lev[j] is level j+1
    denm = 1.0 / (1.0 - rsa_lev * rxa_lev)
    fdndir = tda_lev
    xx4 = tda_lev * rra_lev
    yy = tta_lev - tda_lev
    fdndif = (xx4 * rsa_lev + yy) * denm
    fupdif = (xx4 + yy * rxa_lev) * denm
    flxdn = fdndir + fdndif - fupdif

    # sky-condition weights
    cc1 = jnp.max(fcld[:ict - 1], initial=0.0)
    cc2 = jnp.max(fcld[ict - 1:icb - 1], initial=0.0)
    cc3 = jnp.max(fcld[icb - 1:], initial=0.0)
    wh_ = jnp.stack([1.0 - cc1, cc1])
    wm_ = jnp.stack([1.0 - cc2, cc2])
    wl_ = jnp.stack([1.0 - cc3, cc3])
    ct = wh_[:, None, None] * wm_[None, :, None] * wl_[None, None, :]

    def combo_sum(x):
        return jnp.einsum("lsijk,ijk->ls", x, ct, precision="highest")

    fall = combo_sum(flxdn)               # [np+1, ns]
    fupa = combo_sum(fupdif)
    fclr = flxdn[:, :, 0, 0, 0]
    fupc = fupdif[:, :, 0, 0, 0]
    fsdir_s = combo_sum(fdndir[-1:])[0]   # [ns]
    fsdif_s = combo_sum(fdndif[-1:])[0]

    hk_s = jnp.concatenate([jnp.asarray(hk_uv, dtype),
                            jnp.asarray(hk_ir, dtype).reshape(-1)])
    # NIR ordering: hk_ir[ib, ik] flattened matches s ordering (ib major)

    dot = partial(jnp.dot, precision="highest")
    flx = dot(fall, hk_s)                 # [np+1]
    flc = dot(fclr, hk_s)
    flxu = dot(fupa, hk_s)
    flcu = dot(fupc, hk_s)

    onehot_band = jnp.asarray(
        np.eye(8, dtype=np.float32)[np.asarray(_spectral_constants()[3])],
        dtype)                            # [ns, 8]
    flx_sfc_band = dot(fall[-1] * hk_s, onehot_band)
    drband = dot(fsdir_s * hk_s, onehot_band)
    dfband = dot(fsdif_s * hk_s, onehot_band)

    fdiruv = jnp.sum((fsdir_s * hk_s)[:4])
    fdifuv = jnp.sum((fsdif_s * hk_s)[:4])
    fdirpar = (fsdir_s * hk_s)[4]
    fdifpar = (fsdif_s * hk_s)[4]
    fdirir = jnp.sum((fsdir_s * hk_s)[5:])
    fdifir = jnp.sum((fsdif_s * hk_s)[5:])

    # ---- O2 and CO2 flux reductions (sorad.F90:1425-1543) ----
    t = load("chou_sorad_constants")
    cah = jnp.asarray(t["cah"], dtype)    # (43, 37)
    coa = jnp.asarray(t["coa"], dtype)    # (62, 101)

    cnt = 165.22 * snt
    so2_o2 = (scal0 + jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.cumsum(scal)])) * cnt    # levels 1..np+1
    df = 0.0633 * (1.0 - jnp.exp(-0.000155 * jnp.sqrt(so2_o2)))

    co2v = co2[0] if co2.ndim > 0 else co2
    so2_co2 = (789.0 * co2v) * (scal0 + jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.cumsum(scal)]))

    def rflx_lookup(tab, u, w, u1, du, w1, dw):
        nu_, nw_ = tab.shape
        x0 = u1 + nu_ * du
        y0 = w1 + nw_ * dw
        ulog = jnp.minimum(u, x0)
        wlog = jnp.minimum(w, y0)
        ic = jnp.clip(jnp.floor((ulog - (u1 - 0.5 * du)) / du + 1.0)
                      .astype(jnp.int32), 2, nu_)
        iw = jnp.clip(jnp.floor((wlog - (w1 - 0.5 * dw)) / dw + 1.0)
                      .astype(jnp.int32), 2, nw_)
        dc = ulog - (ic - 2).astype(dtype) * du - u1
        dd = wlog - (iw - 2).astype(dtype) * dw - w1
        t00 = tab[ic - 2, iw - 2]
        t01 = tab[ic - 2, iw - 1]
        t10 = tab[ic - 1, iw - 2]
        x2 = t00 + (t01 - t00) / dw * dd
        y2 = x2 + (t10 - t00) / du * dc
        return jnp.maximum(y2, 0.0)

    df = df + 1.5 * rflx_lookup(cah, jnp.log10(so2_co2 * snt),
                                jnp.log10(swh * snt), -3.0, 0.15, -4.0, 0.15)
    df = df + 1.5 * rflx_lookup(coa, jnp.broadcast_to(co2v * snt, swh.shape),
                                jnp.log10(pl), 0.000250, 0.000050, -2.0, 0.05)

    # adjust below cloud top (Eq. 6.18)
    cloudy_lay = fcld > 0.02
    any_cloud = jnp.any(cloudy_lay)
    ntop_lay = jnp.argmax(cloudy_lay)    # first cloudy layer (0-based)
    ntop = jnp.where(any_cloud, ntop_lay, np_)   # level index 0-based
    flx_ntop = flx[ntop]
    df_ntop = df[ntop]
    lev = jnp.arange(np_ + 1)
    adj = df_ntop + (flx / jnp.where(flx_ntop != 0.0, flx_ntop, 1.0)) \
        * (df - df_ntop)
    df = jnp.where(lev > ntop, adj, df)

    df = jnp.minimum(df, flx - 1.0e-8)
    flx = flx - df
    flc = flc - df

    xx4 = flx[-1] + df[-1]
    scale = jnp.where(jnp.abs(xx4) > 1e-30,
                      jnp.clip(1.0 - df[-1] / xx4, 0.0, 1.0), 0.0)
    return dict(
        flx=flx, flc=flc, flxu=flxu, flcu=flcu,
        fdiruv=fdiruv * scale, fdifuv=fdifuv * scale,
        fdirpar=fdirpar * scale, fdifpar=fdifpar * scale,
        fdirir=fdirir * scale, fdifir=fdifir * scale,
        flx_sfc_band=flx_sfc_band * scale,
        drband=drband * scale, dfband=dfband * scale)


@partial(jax.jit, static_argnames=("ict", "icb"))
def chou_sw(cosz, ple, ta, wa, oa, co2, cwc, fcld, reff,
            taua=None, ssaa=None, asya=None,
            rsuvbm=None, rsuvdf=None, rsirbm=None, rsirdf=None,
            hk_uv=None, hk_ir=None, *, ict, icb):
    """Batched Chou-Suarez SW fluxes (normalized by TOA insolation).

    Args:
      cosz: [ncol] cosine solar zenith angle
      ple:  [ncol, np+1] level pressure (Pa)
      ta/wa/oa: [ncol, np] temperature / specific humidity / ozone mmr
      co2:  [ncol, np] volume mixing ratio (only co2[:, 0] is used; the
            scheme treats CO2 as well-mixed)
      cwc/reff: [ncol, np, 4]; fcld: [ncol, np]
      taua/ssaa/asya: [ncol, np, 8] aerosol optics per band
      rsuvbm/rsuvdf/rsirbm/rsirdf: [ncol] surface albedos
      hk_uv [5], hk_ir [3, 10]: band spectral weights (default: hk_*_old)
      ict/icb: static super-layer boundary level indices (1-based)

    Returns dict with flx/flc (net down), flxu/flcu (diffuse up), surface
    direct/diffuse components, and per-band surface fluxes. All normalized:
    multiply by cosz * solar-constant for W/m^2.
    """
    ncol, np_ = ta.shape
    dt = ta.dtype
    if taua is None:
        taua = jnp.zeros((ncol, np_, 8), dt)
        ssaa = jnp.zeros_like(taua)
        asya = jnp.zeros_like(taua)
    zeros = jnp.zeros((ncol,), dt)
    rsuvbm = zeros if rsuvbm is None else rsuvbm
    rsuvdf = zeros if rsuvdf is None else rsuvdf
    rsirbm = zeros if rsirbm is None else rsirbm
    rsirdf = zeros if rsirdf is None else rsirdf
    if hk_uv is None:
        hk_uv, hk_ir = default_hk()
    hk_uv = jnp.broadcast_to(jnp.asarray(hk_uv, dt), (ncol, 5))
    hk_ir = jnp.broadcast_to(jnp.asarray(hk_ir, dt), (ncol, 3, 10))
    fn = partial(_chou_sw_column, ict=ict, icb=icb)
    return jax.vmap(fn)(cosz, ple, ta, wa, oa, co2, cwc, fcld, reff,
                        taua, ssaa, asya, rsuvbm, rsuvdf, rsirbm, rsirdf,
                        hk_uv, hk_ir)
