"""RRTMG-SW two-stream spectral solver (spcvmc/reftra/vrtqdr).

Re-derivation of rrtmg_sw_spcvmc.F90:30-1590: PIFM two-stream layer
reflectance/transmittance (reftra_sw, kmodts=2), vertical adding
(vrtqdr_sw) as two lax.scans (composite-from-surface and
composite-from-TOA), run once with clear-sky optics and once with McICA
cloud optics added, then spectral/band flux aggregation.

All arrays TOA-first: layer k spans levels k (top) and k+1 (bottom).
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

from .tables_sw import NG_SW

_NGB14 = np.repeat(np.arange(1, 15), NG_SW)    # g-point -> ibm (1..14)
_OD_LO = 0.06
_EPS = 1.0e-8
_ZSR3 = np.sqrt(3.0)
_ZWCRIT = 0.9999995
_WCRIT_RESID = 1.0 - _ZWCRIT


# smallest cosine of the solar zenith angle the solver uses: a lit column
# below it is computed (and must be normalized) as if at MU0_MIN
MU0_MIN = 1e-4


def reftra_sw(tau, w, g, mu0, womz=None):
    """PIFM two-stream R/T of homogeneous layers (reftra_sw, kmodts=2).

    tau/w/g: [..., nlay, ngpt]; mu0: [...] broadcastable.
    womz: optional 1-w computed by the caller at full RELATIVE
    precision directly from optical depths (absorption/total). The
    conservative-scattering predicate zwo >= 0.9999995
    (rrtmg_sw_spcvmc.F90:1212,1267) compares a quantity within 5e-7 of
    1; f32 rounding of w itself quantizes (1-w) to ~12% relative steps
    there (ulp(1) = 6e-8), so ANY pipeline wobble in how w was rounded
    flips cells between branches (the r4 clearsky_e2e_sw instability).
    The reference stabilizes this by carrying spcvmc in real*8; the
    float32 equivalent here is the identity 1-zwo = (1-w)(1-q)/den with
    1-w supplied exactly - the predicate then wobbles only with the
    ~1e-5 relative taumol differences, which cannot cross the
    threshold. The intrinsic O(1e-3) branch disagreement AT the
    threshold (thick layers) is the reference's own and is unchanged.

    Returns (ref, tra, refd, trad) same shape as tau.
    """
    if womz is None:
        womz = 1.0 - w
    mu0 = mu0[..., None, None]
    zg3 = 3.0 * g
    gamma1 = (8.0 - w * (5.0 + zg3)) * 0.25
    gamma2 = 3.0 * (w * (1.0 - g)) * 0.25
    gamma3 = (2.0 - zg3 * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    # original (pre-delta) ssa to detect conservative scattering; guard
    # the catastrophic denominator (spcvmc.F90:1240-1262)
    q = (g / (1.0 - g)) ** 2
    den = 1.0 - womz * q
    den = jnp.where(jnp.abs(den) < 1e-12,
                    jnp.where(den < 0, -1e-12, 1e-12), den)
    conservative = womz * (1.0 - q) / den <= _WCRIT_RESID

    # ---- conservative branch ----
    za = gamma1 * mu0
    za1c = za - gamma3
    zgt = gamma1 * tau
    ze1c = jnp.minimum(tau / mu0, 500.0)
    ze2c = jnp.exp(-ze1c)
    ref_c = (zgt - za1c * (1.0 - ze2c)) / (1.0 + zgt)
    tra_c = 1.0 - ref_c
    refd_c = zgt / (1.0 + zgt)
    trad_c = 1.0 - refd_c
    thin = ze2c == 1.0
    ref_c = jnp.where(thin, 0.0, ref_c)
    tra_c = jnp.where(thin, 1.0, tra_c)
    refd_c = jnp.where(thin, 0.0, refd_c)
    trad_c = jnp.where(thin, 1.0, trad_c)

    # ---- non-conservative branch ----
    # The reference's direct-beam expressions (rrtmg_sw_spcvmc.F90:
    # 1290-1345) have a REMOVABLE singularity at zrk*mu0 = 1 (the
    # particular-solution resonance): zdenr = (1-(zrk*mu0)^2)*(...)->0
    # while the numerators cancel to the same order. In real*8 the
    # cancellation noise is ~1e-16/|1-(zrk*mu0)^2|, invisible; in f32 it
    # reaches O(0.1) on tra within |1-zrk*mu0| < 1e-4 of the resonance
    # (this is the true reason the reference carries spcvmc in real*8).
    # Fix: factor the singular s = 1-zrk*mu0 out analytically
    #   N_tra = (za1+k*g4)(1+p)(E1-E2p) + (za1-k*g4)*s*(E2p-Em1)
    #   N_ref = (za2+k*g3)*s*(E1-Em2)  + (k*g3-za2)(1+p)(Em1-Em2)
    #   D     = s*(1+p)*[(k+g1)*E1 + (k-g1)*Em1]
    # with E1-E2p = zep2*expm1(-u), Em1-Em2 = zem2*expm1(u), u = ze2-ze1
    # = s*tau/mu0; expm1(±u)/s = ±r*psi(±u), r = u/s. Every s cancels,
    # leaving a strictly positive O(1) denominator - algebraically
    # identical to the reference (the implemented float32 form agrees
    # with it to about 6e-6 relative) and f32-stable through the
    # resonance (err <= 4e-4 AT it vs 0.17 for the direct form).
    # Requires exact exp for zem1/zem2 (the <=0.06 Taylor shortcut would
    # break the exponent identities by its own 3.6e-5 error amplified
    # by 1/s).
    za1 = gamma1 * gamma4 + gamma2 * gamma3
    za2 = gamma1 * gamma3 + gamma2 * gamma4
    zrk = jnp.sqrt(jnp.maximum(gamma1 * gamma1 - gamma2 * gamma2, 1e-12))
    zrp = zrk * mu0
    opp = 1.0 + zrp
    s = 1.0 - zrp                 # exact (Sterbenz) for zrp in [0.5, 2]
    zrk2 = 2.0 * zrk
    zrkg = zrk + gamma1
    g3k = zrk * gamma3
    g4k = zrk * gamma4
    zbeta = (gamma1 - zrk) / zrkg

    ze1 = jnp.minimum(zrk * tau, 5.0)
    ze2 = jnp.minimum(tau / mu0, 5.0)
    zem1 = jnp.exp(-ze1)
    # exp(ze) rather than 1/zem: XLA rewrites 1/exp(-x) -> exp(x) under
    # jit but not in eager dispatch, and that one-ulp difference is the
    # dominant compilation-variance of the whole solver (measured
    # 3.4e-4 max flux drift jit-vs-eager with the reciprocal, 0.0 with
    # the direct form)
    zep1 = jnp.exp(ze1)
    zem2 = jnp.exp(-ze2)
    zep2 = jnp.exp(ze2)

    u = ze2 - ze1                 # = s*tau/mu0 when neither clamps
    s_ok = jnp.abs(s) >= 1e-6
    r = jnp.where(s_ok, u / jnp.where(s_ok, s, 1.0),
                  jnp.where(u == 0.0, 0.0, ze2))
    # psi(+-u) = +-expm1(+-u)/u via exp-1 with a quadratic Taylor below
    # |u| <= 0.01 (crossover errors ~6e-6 rel on each side)
    small_u = jnp.abs(u) <= 0.01
    u_safe = jnp.where(small_u, 1.0, u)
    psi_p = jnp.where(small_u, 1.0 + u * (0.5 + u * (1.0 / 6.0)),
                      (jnp.exp(u) - 1.0) / u_safe)
    psi_m = jnp.where(small_u, 1.0 - u * (0.5 - u * (1.0 / 6.0)),
                      -(jnp.exp(-u) - 1.0) / u_safe)
    zden = opp * (zrkg * zep1 + (zrk - gamma1) * zem1)  # > 0 always
    ref_n = w * ((za2 + g3k) * (zep1 - zem2)
                 + (g3k - za2) * opp * zem2 * r * psi_p) / zden
    tra_n = zem2 * (1.0 - w * ((za1 - g4k) * (zep2 - zem1)
                               - (za1 + g4k) * opp * zep2 * r * psi_m)
                    / zden)
    zemm = zem1 * zem1
    zdend = 1.0 / ((1.0 - zbeta * zemm) * zrkg)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    ref = jnp.where(conservative, ref_c, ref_n)
    tra = jnp.where(conservative, tra_c, tra_n)
    refd = jnp.where(conservative, refd_c, refd_n)
    trad = jnp.where(conservative, trad_c, trad_n)
    return ref, tra, refd, trad


def vrtqdr_sw(ref, tra, refd, trad, ref_sfc_dir, ref_sfc_dif, dbt, tdbt):
    """Vertical adding (vrtqdr_sw) with lax.scans.

    ref/tra/refd/trad: [..., nlay, ngpt] layer properties (TOA-first).
    ref_sfc_dir/dif: [..., ngpt] surface reflectivities.
    dbt: [..., nlay, ngpt] layer direct transmittance.
    tdbt: [..., nlay+1, ngpt] cumulative direct transmittance at levels.

    Returns (fd, fu): [..., nlay+1, ngpt] normalized fluxes.
    """
    nlay = ref.shape[-2]

    def mov(x):
        return jnp.moveaxis(x, -2, 0)

    ref_l, tra_l, refd_l, trad_l, dbt_l = map(
        mov, (ref, tra, refd, trad, dbt))
    tdbt_l = jnp.moveaxis(tdbt, -2, 0)

    # composite below level k: scan up from the surface
    def up_step(carry, xs):
        rup, rupd = carry
        rf, tr, rfd, trd, db = xs
        zrefl = 1.0 / (1.0 - rupd * rfd)
        rup_n = rf + trd * ((tr - db) * rupd + db * rup) * zrefl
        rupd_n = rfd + trd * trd * rupd * zrefl
        return (rup_n, rupd_n), (rup_n, rupd_n)

    carry0 = (ref_sfc_dir, ref_sfc_dif)
    # reverse=True scans surface->TOA without materializing flipped
    # copies and stacks ys at original positions:
    # rup_seq[k] = composite below level k
    _, (rup_seq, rupd_seq) = lax.scan(
        up_step, carry0, (ref_l, tra_l, refd_l, trad_l, dbt_l),
        reverse=True)
    prup = jnp.concatenate([rup_seq, ref_sfc_dir[None]], axis=0)
    prupd = jnp.concatenate([rupd_seq, ref_sfc_dif[None]], axis=0)

    # composite above level k: scan down from TOA
    one = jnp.ones_like(ref_sfc_dir)
    zero = jnp.zeros_like(ref_sfc_dir)

    def down_step(carry, xs):
        ztdn, rdnd = carry
        rf, tr, rfd, trd, db, tdb = xs
        zrefl = 1.0 / (1.0 - rfd * rdnd)
        ztdn_n = tdb * tr + trd * ((ztdn - tdb) + tdb * rf * rdnd) * zrefl
        rdnd_n = rfd + trd * trd * rdnd * zrefl
        return (ztdn_n, rdnd_n), (ztdn_n, rdnd_n)

    _, (tdn_seq, rdnd_seq) = lax.scan(
        down_step, (one, zero),
        (ref_l, tra_l, refd_l, trad_l, dbt_l, tdbt_l[:-1]))
    ztdn = jnp.concatenate([one[None], tdn_seq], axis=0)
    prdnd = jnp.concatenate([zero[None], rdnd_seq], axis=0)

    zrefl = 1.0 / (1.0 - prdnd * prupd)
    fu = (tdbt_l * prup + (ztdn - tdbt_l) * prupd) * zrefl
    fd = tdbt_l + (ztdn - tdbt_l + tdbt_l * prup * prdnd) * zrefl
    return jnp.moveaxis(fd, 0, -2), jnp.moveaxis(fu, 0, -2)


def spcvmc_sw(coefs, taug, taur, sfluxzen, mu0, albdir, albdif,
              cldymc, taucmc, ssacmc, asmcmc,
              taua=None, ssaa=None, asya=None, adjflux=1.0, ncld=None):
    """SW flux solver over 112 g-points, clear + McICA-cloudy passes.

    coefs: SWCoefs; taug/taur [ncol, nlay, 112]; sfluxzen [ncol, 112];
    mu0 [ncol]; albdir/albdif [ncol, 14]; cloud arrays [ncol, nlay, 112];
    taua/ssaa/asya: optional aerosol optics [ncol, nlay, 14].
    adjflux: scalar Earth-Sun distance factor.
    ncld: optional STATIC bound on the number of LEADING columns that
    can be cloudy (caller sorts cloudy-first and buckets the count, as
    with rrtmg_sw's nlit). The cloudy two-stream+adding pass - the
    expensive half of this solver - then runs only on those columns;
    for the rest the all-sky outputs ALIAS the clear-sky solve, which
    is what the cloudy pass degenerates to on a clear column anyway
    (tau_all == ztauo_c elementwise). This is the solver half of the
    reference's clear/cloudy gridcolumn partitioning
    (rrtmg_sw_rad.F90:1130-1204).

    Returns dict of [ncol, nlay+1] fluxes (W/m^2): bbfu, bbfd, bbcu, bbcd,
    bbfddir, bbcddir, uvfd, uvcd, uvfddir, uvcddir, nifd, nicd, nifddir,
    nicddir; plus surface band quantities.
    """
    dtype = taug.dtype
    ncol, nlay, ngpt = taug.shape
    if ncld is not None and ncld >= ncol:
        ncld = None
    mu0c = jnp.maximum(mu0, MU0_MIN)

    ngb = _NGB14                                  # 1..14 per g
    if taua is None:
        taua_g = jnp.zeros_like(taug)
        ssaa_g = jnp.zeros_like(taug)
        asya_g = jnp.zeros_like(taug)
    else:
        taua_g = taua[..., ngb - 1]
        ssaa_g = ssaa[..., ngb - 1]
        asya_g = asya[..., ngb - 1]

    # clear-sky optical properties + delta scaling (spcvmc.F90:340-356)
    ztauo = taur + taug + taua_g
    zomco = taur + taua_g * ssaa_g
    zgco = (asya_g * ssaa_g * taua_g) / jnp.maximum(zomco, 1e-30)
    zomco = zomco / ztauo
    zf = zgco * zgco
    zwf = zomco * zf
    ztauo_c = (1.0 - zwf) * ztauo
    zomco_c = (zomco - zwf) / (1.0 - zwf)
    zgco_c = (zgco - zf) / (1.0 - zf)
    # 1 - zomco_c at full RELATIVE precision (see reftra_sw docstring):
    # 1-zomco = absorption/total = (taug + taua*(1-ssaa))/ztauo exactly,
    # and delta scaling divides it by (1-zwf)
    womz_c = (taug + taua_g * (1.0 - ssaa_g)) / ztauo / (1.0 - zwf)

    ref_sfc_dir = albdir[..., ngb - 1]
    ref_sfc_dif = albdif[..., ngb - 1]

    def solve(tau, w, g, womz, mu0v, rdir, rdif):
        ref, tra, refd, trad = reftra_sw(tau, w, g, mu0v, womz)
        dbt = jnp.exp(-jnp.minimum(tau / mu0v[..., None, None], 500.0))
        tdbt = jnp.concatenate(
            [jnp.ones_like(dbt[..., :1, :]),
             jnp.cumprod(dbt, axis=-2)], axis=-2)
        fd, fu = vrtqdr_sw(ref, tra, refd, trad, rdir, rdif, dbt, tdbt)
        return fd, fu, tdbt

    # cloudy: add (already delta-scaled) cloud optics where cloudy;
    # under ncld only the leading (sorted-cloudy) columns pay the pass
    cs = (lambda x: x) if ncld is None else (lambda x: x[:ncld])
    tauo_s, omco_s, gco_s, womz_s = map(
        cs, (ztauo_c, zomco_c, zgco_c, womz_c))
    cldy_s, tcm_s, scm_s, acm_s = map(
        cs, (cldymc, taucmc, ssacmc, asmcmc))
    tg = tauo_s * omco_s * gco_s + tcm_s * scm_s * acm_s
    to_ = tauo_s * omco_s + tcm_s * scm_s
    tt = tauo_s + tcm_s
    g_all = tg / jnp.maximum(to_, 1e-30)
    w_all = to_ / tt
    # 1 - w_all = (absorption_clear + absorption_cloud)/total, exact
    womz_all = (tauo_s * womz_s + tcm_s * (1.0 - scm_s)) / tt
    tau_all = jnp.where(cldy_s, tt, tauo_s)
    w_all = jnp.where(cldy_s, w_all, omco_s)
    g_all = jnp.where(cldy_s, g_all, gco_s)
    womz_all = jnp.where(cldy_s, womz_all, womz_s)

    # Separate clear and all-sky solves: stacking them along the g-axis
    # (one 224-g solve) halves the step count but doubles the step width
    # of bandwidth-bound scans and adds concat/split copies.
    fd_c, fu_c, tdbt_c = solve(ztauo_c, zomco_c, zgco_c, womz_c,
                               mu0c, ref_sfc_dir, ref_sfc_dif)
    if ncld is None:
        fd_a, fu_a, tdbt_a = solve(tau_all, w_all, g_all, womz_all,
                                   mu0c, ref_sfc_dir, ref_sfc_dif)
    else:
        fd_h, fu_h, tdbt_h = solve(tau_all, w_all, g_all, womz_all,
                                   mu0c[:ncld], ref_sfc_dir[:ncld],
                                   ref_sfc_dif[:ncld])
        cat = lambda h, c: jnp.concatenate([h, c[ncld:]], axis=0)
        fd_a = cat(fd_h, fd_c)
        fu_a = cat(fu_h, fu_c)
        tdbt_a = cat(tdbt_h, tdbt_c)

    # incident flux per g-point
    zincflx = adjflux * sfluxzen * mu0c[..., None]     # [ncol, ngpt]

    uv_mask = jnp.asarray((ngb >= 10) & (ngb <= 13), dtype)
    nir_mask = jnp.asarray((ngb <= 9) | (ngb == 14), dtype)

    def agg(x, mask=None):
        wgt = zincflx if mask is None else zincflx * mask
        return jnp.einsum("clg,cg->cl", x, wgt,
                          precision="highest")

    out = dict(
        bbcu=agg(fu_c), bbcd=agg(fd_c), bbcddir=agg(tdbt_c),
        bbfu=agg(fu_a), bbfd=agg(fd_a), bbfddir=agg(tdbt_a),
        uvcd=agg(fd_c, uv_mask), uvcddir=agg(tdbt_c, uv_mask),
        uvfd=agg(fd_a, uv_mask), uvfddir=agg(tdbt_a, uv_mask),
        nicd=agg(fd_c, nir_mask), nicddir=agg(tdbt_c, nir_mask),
        nifd=agg(fd_a, nir_mask), nifddir=agg(tdbt_a, nir_mask))

    # surface band aggregation (spcvmc.F90:520-556): nir = bands<=8 or 14,
    # par = 10-11 (+half of 9), uv = 12-13 (+... band 9 half to nir)
    sfc_dir = tdbt_a[..., -1, :] * zincflx      # per g
    sfc_tot = fd_a[..., -1, :] * zincflx
    sfc_up = fu_a[..., -1, :] * zincflx

    def band_sum(x, sel):
        return jnp.einsum("cg,g->c", x, jnp.asarray(sel, dtype),
                          precision="highest")

    nir_sel = ((ngb <= 8) | (ngb == 14)).astype(np.float32) \
        + 0.5 * (ngb == 9)
    par_sel = ((ngb >= 10) & (ngb <= 11)).astype(np.float32) \
        + 0.5 * (ngb == 9)
    uvr_sel = ((ngb >= 12) & (ngb <= 13)).astype(np.float32)
    out["nirr"] = band_sum(sfc_dir, nir_sel)
    out["nirf"] = band_sum(sfc_tot, nir_sel)
    out["parr"] = band_sum(sfc_dir, par_sel)
    out["parf"] = band_sum(sfc_tot, par_sel)
    out["uvrr"] = band_sum(sfc_dir, uvr_sel)
    out["uvrf"] = band_sum(sfc_tot, uvr_sel)

    onehot = jnp.asarray(np.eye(14, dtype=np.float32)[ngb - 1], dtype)
    hd = lambda a: jnp.einsum("cg,gb->cb", a, onehot,
                          precision="highest")
    out["fndsbnd"] = hd(sfc_tot - sfc_up)
    out["drband"] = hd(sfc_dir)
    out["dfband"] = hd(sfc_tot - sfc_dir)
    return out
