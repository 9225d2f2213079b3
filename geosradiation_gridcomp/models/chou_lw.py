"""Chou-Suarez longwave flux solver (JAX re-derivation of `irrad`).

Physics follows the reference kernel /root/reference/GEOSirrad_GridComp/
irrad.F90:27-1338 (10-band k-distribution + table-lookup transmission,
max-random 3-super-layer cloud overlap, linearized surface-temperature
Jacobian dF/dTs), but the implementation is restructured for XLA:

* Every per-layer exponential factor in the reference (h2oexps/conexps/
  n2oexps/... irrad.F90:1379-1883) is exp(-k_i * u_layer) for a scaled
  absorber amount u; the reference multiplies them incrementally along the
  O(np^2) (k1,k2) path loop. Here path transmittances are differences of
  LEVEL CUMULATIVE SUMS of u, so the whole pair loop becomes broadcasted
  arithmetic on (np+1, np+2) arrays - no serial dependence, fully vectorized
  over columns, pairs, and k-terms.
* The table-lookup bands (h2o bands 1/2/8, co2 band 3, o3 band 5;
  irrad.F90:1887-2013 `tablup`) likewise depend only on path sums of
  (dw, p*dw, dt*dw), evaluated as vectorized gathers from the 26x31/30/21
  tables.
* Max-random overlap (irrad.F90:2513-2603 `cldovlp` + `mkicx`): the
  effective superlayer cloud fraction for a path is a linear recurrence over
  the superlayer's layers sorted by ascending effective cloudiness. This is
  computed for ALL (k1,k2) pairs at once by a lax.scan over sorted layer
  positions with per-pair masks.

Fluxes keep the reference sign convention: downward positive, upward
negative. Outputs are W/m^2 at the np+1 model levels (TOA..surface).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import DIFFUSIVITY
from ..ops.chou_optics import getirtau
from ..tables import load

# CFC temperature-scaling/absorption parameters (irrad.F90:739-770, Table 7)
_CFC_PARAMS = {
    "f11": (1.26610e-3, 3.55940e-6, 1.89736e1, 8.19370e-4, 4.67810e-6, 1.01487e1),
    "f12": (8.77370e-4, -5.88440e-6, 1.58104e1, 8.62000e-4, -4.22500e-6, 3.70107e1),
    "f22": (9.65130e-4, 1.31280e-5, 6.18536e0, -3.00010e-5, 5.25010e-7, 3.27912e1),
}

# k-distribution weights for trace gases (irrad.F90:2185-2356, Tables 5-6)
_N2O_W = {6: (0.940414, 0.059586), 7: (0.561961, 0.138707, 0.240670, 0.058662)}
_N2O_POW = {6: 21.0, 7: 8.0}
_N2O_K = {6: 6.31582e-2, 7: 5.35779e-2}
_CH4_W = {6: (1.0,), 7: (0.610650, 0.280212, 0.107349, 0.001789)}
_CH4_POW = {6: 1.0, 7: 12.0}
_CH4_K = {6: 5.80708e-3, 7: 6.29247e-2}
_COM_W = {4: (0.12159, 0.24359, 0.24981, 0.26427, 0.07807, 0.04267),
          5: (0.06869, 0.14795, 0.19512, 0.33446, 0.17199, 0.08179)}
_COM_K = 1.922e-7   # powers of 5, 6 terms
# band 10 (irrad.F90:1806-1883, 2450-2505)
_B10_H2O_W = (0.3153, 0.4604, 0.1326, 0.0798, 0.0119)
_B10_CO2_W = (0.2673, 0.2201, 0.2106, 0.2409, 0.0196, 0.0415)
_B10_N2O_W = (0.970831, 0.029169)


def _planck_all_bands(cb, t):
    """Spectrally-integrated Planck flux for all 10 bands. irrad.F90:1341-1356.

    cb: (6, 10) polynomial coefficients; t: scalar temperature.
    Returns (10,).
    """
    out = cb[5]
    for i in (4, 3, 2, 1, 0):
        out = out * t + cb[i]
    return out


def _plancd_all_bands(dcb, t):
    """d(Planck flux)/dT for all 10 bands. irrad.F90:1360-1375."""
    out = dcb[4]
    for i in (3, 2, 1, 0):
        out = out * t + dcb[i]
    return out


def _pair_delta(x):
    """Pair path sums from per-layer x: out[k1, k2] = sum_{k=k1}^{k2-1} x[k].

    x: [nl]; returns [nl, nl+1] (k1 = 0..nl-1, k2 = 0..nl).
    Entries with k2 <= k1 are meaningless (negative sums); callers mask.
    """
    c = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])
    return c[None, :] - c[:-1, None]


def _kdist_tran(du, kbase, mult, weights):
    """Sum_i w_i * exp(-kbase * mult^(i-1) * du)  (Eqs. 8.23/8.25)."""
    out = 0.0
    k = kbase
    for w in weights:
        out = out + w * jnp.exp(-k * jnp.maximum(du, 0.0))
        k = k * mult
    return out


def _tablup(s1, s2, s3, c1, c2, c3, w1, p1, dwe, dpe):
    """Vectorized table lookup transmittance factor. irrad.F90:1887-2013.

    s1/s2/s3: path sums of (dw, p*dw, dt*dw), any shape.
    c1/c2/c3: (nx, nh) tables. Returns transmittance factor in [1e-7, ~1].
    """
    nx, nh = c1.shape
    c1 = jnp.asarray(c1)
    c2 = jnp.asarray(c2)
    c3 = jnp.asarray(c3)
    s1c = jnp.maximum(s1, 1e-30)
    x2 = s2 / s1c
    x3 = s3 / s1c
    we = jnp.minimum((jnp.log10(s1c) - w1) * dwe, float(nh - 1))
    pe = jnp.minimum((jnp.log10(jnp.maximum(x2, 1e-30)) - p1) * dpe,
                     float(nx - 1))
    iw = jnp.clip(jnp.floor(we + 1.0).astype(jnp.int32), 2, nh - 1)
    fw = we - (iw - 1).astype(we.dtype)
    ip = jnp.clip(jnp.floor(pe + 1.0).astype(jnp.int32), 1, nx - 1)
    fp = pe - (ip - 1).astype(pe.dtype)

    # 0-based gathers; Fortran coef(ip, iw) -> c[ip-1, iw-1]
    i0 = ip - 1
    j0 = iw - 1

    def g(c, di, dj):
        return c[i0 + di, j0 + dj]

    pa_ = g(c1, 0, -1) + (g(c1, 1, -1) - g(c1, 0, -1)) * fp
    pb_ = g(c1, 0, 0) + (g(c1, 1, 0) - g(c1, 0, 0)) * fp
    pc_ = g(c1, 0, 1) + (g(c1, 1, 1) - g(c1, 0, 1)) * fp
    ax = ((pc_ + pa_) * fw + (pc_ - pa_)) * fw * 0.5 + pb_ * (1.0 - fw * fw)
    ba = g(c2, 0, 0) + (g(c2, 1, 0) - g(c2, 0, 0)) * fp
    bb = g(c2, 0, 1) + (g(c2, 1, 1) - g(c2, 0, 1)) * fp
    t1 = ba + (bb - ba) * fw
    ca = g(c3, 0, 0) + (g(c3, 1, 0) - g(c3, 0, 0)) * fp
    cb_ = g(c3, 0, 1) + (g(c3, 1, 1) - g(c3, 0, 1)) * fp
    t2 = ca + (cb_ - ca) * fw
    return jnp.clip(ax + (t1 + t2 * x3) * x3, 1e-7, 0.9999999)


def _superlayer_cloud(enn_b, tcld_b, lo, hi, nl):
    """Effective cloudiness of superlayer [lo, hi] for all (k1, k2) pairs.

    Replicates cldovlp/mkicx semantics (irrad.F90:2513-2780): within the
    superlayer, layers are processed in ascending order of enn (stable), with
    the recurrence c <- enn_j + tcld_j * c for layers j in [k1, E(k2)] where
    E(k2) is the deepest layer above k2 with enn >= 0.001 (updates in the
    reference only trigger on such layers).

    Returns [nl, nl+1] effective cloud fraction per (k1, k2) pair.
    """
    idx = jnp.arange(lo, hi + 1)
    enn_s = enn_b[lo:hi + 1]
    order = jnp.argsort(enn_s, stable=True)
    js = idx[order]

    cloudy = enn_b >= 0.001
    in_s = (jnp.arange(nl) >= lo) & (jnp.arange(nl) <= hi)
    marker = jnp.where(cloudy & in_s, jnp.arange(nl), -1)
    # E[k2] = max marker over layers < k2 ; length nl+1
    emax = jnp.concatenate(
        [jnp.full((1,), -1, marker.dtype),
         lax.associative_scan(jnp.maximum, marker)])

    k1_idx = jnp.arange(nl)[:, None]

    def step(c, j):
        m = (j >= k1_idx) & (j <= emax[None, :])
        return jnp.where(m, enn_b[j] + tcld_b[j] * c, c), None

    c0 = jnp.zeros((nl, nl + 1), enn_b.dtype)
    c, _ = lax.scan(step, c0, js)
    return c


def _chou_lw_column(ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4,
                    cfc11, cfc12, cfc22, cwc, fcld, reff, taua, ssaa, asya,
                    *, ict, icb, trace, with_aerosol):
    """Single-column Chou LW. All inputs per-column; vmapped by chou_lw."""
    dtype = ta.dtype
    t = load("chou_irrad_constants")
    cb = jnp.asarray(t["cb"], dtype)
    dcb = jnp.asarray(t["dcb"], dtype)
    xkw = t["xkw"]
    xke = t["xke"]
    mw = t["mw"]
    aw = t["aw"]
    bw = t["bw"]
    pm = t["pm"]
    fkw = t["fkw"]     # (6, 9)
    gkw = t["gkw"]     # (6, 3)

    np_ = ta.shape[0]
    nl = np_ + 1        # extended layers: virtual layer 0 above model top

    # ---- extended layer quantities (irrad.F90:377-453) ----
    def ext(x):
        return jnp.concatenate([x[:1], x])

    dp_mod = (ple[1:] - ple[:-1]) * 0.01            # hPa
    dp0 = jnp.maximum(ple[0] * 0.01, 0.005)
    dp = jnp.concatenate([dp0[None], dp_mod])
    pa = jnp.concatenate([(0.5 * dp0)[None],
                          0.5 * (ple[1:] + ple[:-1]) * 0.01])
    ta_e = ext(ta)
    wa_e = ext(wa)
    dt = ta_e - 250.0

    dh2o = jnp.maximum(1.02 * wa_e * dp, 1e-10)
    do3 = jnp.maximum(476.0 * ext(oa) * dp, 1e-6)
    dco2 = jnp.maximum(789.0 * ext(co2) * dp, 1e-4)
    dch4 = 789.0 * ext(ch4) * dp
    dn2o = 789.0 * ext(n2o) * dp
    df11 = 789.0 * ext(cfc11) * dp
    df12 = 789.0 * ext(cfc12) * dp
    df22 = 789.0 * ext(cfc22) * dp
    dcont = (pa * 0.001618 * wa_e * wa_e * dp
             * jnp.exp(1800.0 / ta_e - 6.081))

    # ---- cloud optics: 10 bands x extended layers ----
    tcld_m, enn_m, _ = getirtau(ple[1:] - ple[:-1], fcld, reff, cwc,
                                dtype=dtype)
    ones_b = jnp.ones((10, 1), dtype)
    tcld = jnp.concatenate([ones_b, tcld_m], axis=1)      # (10, nl)
    enn = jnp.concatenate([jnp.zeros((10, 1), dtype), enn_m], axis=1)

    # ---- aerosol effective optical depth per band (irrad.F90:670-692) ----
    if with_aerosol:
        w_ratio = ssaa / jnp.maximum(taua, 1e-20)
        g_ratio = asya / jnp.maximum(ssaa, 1e-20)
        ffa = 0.5 + (0.3739 + (0.0076 + 0.1185 * g_ratio) * g_ratio) * g_ratio
        tau_scaled = jnp.where(ssaa > 0.001, taua * (1.0 - w_ratio * ffa),
                               taua)
        taua_eff = jnp.where(taua > 0.001, tau_scaled, 0.0)  # (np, 10)
        taua_eff = jnp.concatenate(
            [jnp.zeros((1, 10), dtype), taua_eff], axis=0)   # (nl, 10)

    # ---- surface (homogeneous, no vegetation; irrad.F90:2662-2670) ----
    bg = _planck_all_bands(cb, ts)          # (10,)
    dbg = _plancd_all_bands(dcb, ts)
    bs_b = emis * bg
    dbs_b = emis * dbg
    rflxs_b = 1.0 - emis

    # ---- Planck profiles per band ----
    blayer = jax.vmap(lambda tt: _planck_all_bands(cb, tt))(ta_e).T  # (10, nl)
    bsurf_lev = _planck_all_bands(cb, tb)   # blevel(np+1) from surface air T

    # blevel (10, nl+1): levels 0..np+1 (extended level j corresponds to
    # Fortran level j; level 0 == level 1)
    dpm = dp_mod
    inner = ((blayer[:, 1:-1] * dpm[None, 1:]
              + blayer[:, 2:] * dpm[None, :-1])
             / (dpm[None, :-1] + dpm[None, 1:]))           # levels 2..np
    blev1 = (blayer[:, 1] + (blayer[:, 1] - blayer[:, 2])
             * dpm[0] / (dpm[0] + dpm[1]))                  # level 1
    blevel = jnp.concatenate(
        [blev1[:, None], blev1[:, None], inner, bsurf_lev[:, None]], axis=1)

    # ---- path-sum building blocks ----
    tri = (jnp.arange(nl + 1)[None, :] > jnp.arange(nl)[:, None])  # k2>k1

    d_h2o = _pair_delta(dh2o)
    d_cont = _pair_delta(dcont)
    d_co2 = _pair_delta(dco2)
    d_o3 = _pair_delta(do3)

    # table-band path sums (s1, s2, s3) per gas
    def tab_paths(dw):
        return (_pair_delta(dw), _pair_delta(pa * dw), _pair_delta(dt * dw))

    # scaled k-distribution amounts (Eq. 4.4 scalings, irrad.F90:1425-1457)
    def h2o_scaled(ib):
        return dh2o * (pa / 500.0) ** pm[ib - 1] \
            * (1.0 + (aw[ib - 1] + bw[ib - 1] * dt) * dt)

    flxu = jnp.zeros((nl + 1,), dtype)
    flcu = jnp.zeros((nl + 1,), dtype)
    flau = jnp.zeros((nl + 1,), dtype)
    flxau = jnp.zeros((nl + 1,), dtype)
    flxd = jnp.zeros((nl + 1,), dtype)
    flcd = jnp.zeros((nl + 1,), dtype)
    flad = jnp.zeros((nl + 1,), dtype)
    flxad = jnp.zeros((nl + 1,), dtype)
    dfdts = jnp.zeros((nl + 1,), dtype)
    sfcem = jnp.zeros((), dtype)

    nbands = 10 if trace else 9
    for ib in range(1, nbands + 1):
        bi = ib - 1
        b10 = ib == 10

        # ---- gas transmittance for all pairs ----
        taant = jnp.ones((nl, nl + 1), dtype)
        if ib in (1, 2, 8):
            pre = {1: "h1", 2: "h2", 8: "h8"}[ib]
            s1, s2, s3 = tab_paths(dh2o)
            taant = taant * _tablup(
                s1, s2, s3, t[pre + "1"], t[pre + "2"], t[pre + "3"],
                t["w11"], t["p11"], t["dwe"], t["dpe"])
            if ib == 2:
                taant = taant * jnp.exp(
                    -xke[1] * jnp.maximum(d_cont, 0.0))
        elif not b10:
            du = _pair_delta(h2o_scaled(ib))
            if ib == 3:
                # 3 sub-bands with separate continuum scalings (gkw)
                trn = 0.0
                for sub in range(3):
                    line = _kdist_tran(du, xkw[2], float(mw[2]),
                                       gkw[:, sub])
                    con = jnp.exp(-xke[2] * (2.0 ** sub)
                                  * jnp.maximum(d_cont, 0.0))
                    trn = trn + line * con
                taant = taant * trn
            else:
                trn = _kdist_tran(du, xkw[bi], float(mw[bi]), fkw[:, bi])
                if 2 <= ib <= 7:
                    trn = trn * jnp.exp(-xke[bi] * jnp.maximum(d_cont, 0.0))
                taant = taant * trn
        if ib == 3:
            s1, s2, s3 = tab_paths(dco2)
            taant = taant * _tablup(
                s1, s2, s3, t["c1"], t["c2"], t["c3"],
                t["w12"], t["p12"], t["dwe"], t["dpe"])
        if ib == 5:
            s1, s2, s3 = tab_paths(do3)
            taant = taant * _tablup(
                s1, s2, s3, t["oo1"], t["oo2"], t["oo3"],
                t["w13"], t["p13"], t["dwe"], t["dpe"])

        if trace:
            if ib in (6, 7):
                if ib == 6:
                    un2o = dn2o * (1.0 + (1.9297e-3 + 4.3750e-6 * dt) * dt)
                else:
                    un2o = dn2o * (pa / 500.0) ** 0.48 \
                        * (1.0 + (1.3804e-3 + 7.4838e-6 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(un2o), _N2O_K[ib], _N2O_POW[ib], _N2O_W[ib])
                if ib == 6:
                    uch4 = dch4 * (1.0 + (1.7007e-2 + 1.5826e-4 * dt) * dt)
                else:
                    uch4 = dch4 * (pa / 500.0) ** 0.65 \
                        * (1.0 + (5.9590e-4 - 2.2931e-6 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(uch4), _CH4_K[ib], _CH4_POW[ib], _CH4_W[ib])
            if ib in (4, 5):
                if ib == 4:
                    ucom = dco2 * (1.0 + (3.5775e-2 + 4.0447e-4 * dt) * dt)
                else:
                    ucom = dco2 * (1.0 + (3.4268e-2 + 3.7401e-4 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(ucom), _COM_K, 5.0, _COM_W[ib])
            for gas, dcfc in (("f11", df11), ("f12", df12), ("f22", df22)):
                bands = {"f11": (4, 5), "f12": (4, 6), "f22": (4, 6)}[gas]
                if ib in bands:
                    a1, b1, fk1, a2, b2, fk2 = _CFC_PARAMS[gas]
                    if ib == 4:
                        ucfc = dcfc * (1.0 + (a1 + b1 * dt) * dt)
                        fk = fk1
                    else:
                        ucfc = dcfc * (1.0 + (a2 + b2 * dt) * dt)
                        fk = fk2
                    taant = taant * jnp.exp(
                        -fk * jnp.maximum(_pair_delta(ucfc), 0.0))
            if b10:
                uh2o = dh2o * (pa / 500.0) \
                    * (1.0 + (0.0149 + 6.20e-5 * dt) * dt)
                uco2 = dco2 * (pa / 300.0) ** 0.5 \
                    * (1.0 + (0.0179 + 1.02e-4 * dt) * dt)
                un2o = dn2o * (1.0 + (1.4476e-3 + 3.6656e-6 * dt) * dt)
                th2o = _kdist_tran(_pair_delta(uh2o), 0.10624, 8.0,
                                   _B10_H2O_W)
                tcon = jnp.exp(-109.0 * jnp.maximum(d_cont, 0.0))
                tco2 = _kdist_tran(_pair_delta(uco2), 2.656e-5, 8.0,
                                   _B10_CO2_W)
                tn2o = _kdist_tran(_pair_delta(un2o), 0.25238, 58.0,
                                   _B10_N2O_W)
                taant = th2o * tcon * tco2 * (tn2o - 1.0)

        # ---- aerosol ----
        if with_aerosol:
            tranal = jnp.exp(-DIFFUSIVITY
                             * jnp.maximum(_pair_delta(taua_eff[:, bi]), 0.0))
            trant = taant * tranal
        else:
            trant = taant

        # ---- cloud overlap: fclr for all pairs ----
        enn_b = enn[bi]
        tcld_b = tcld[bi]
        c_hi = _superlayer_cloud(enn_b, tcld_b, 0, ict - 1, nl)
        c_md = _superlayer_cloud(enn_b, tcld_b, ict, icb - 1, nl)
        c_lw = _superlayer_cloud(enn_b, tcld_b, icb, nl - 1, nl)
        fclr = (1.0 - c_hi) * (1.0 - c_md) * (1.0 - c_lw)

        # ---- layer emissions (irrad.F90:804-945) ----
        if b10:
            lay_tr = jnp.ones((nl,), dtype)
            lay_ta = lay_tr
        else:
            lay_tr = jnp.diagonal(trant, offset=1)   # trant(k, k+1)
            lay_ta = jnp.diagonal(taant, offset=1)

        blev = blevel[bi]          # (nl+1,)
        bsum = blev[:-1] + blev[1:]

        def emission(layer_tran):
            # Eqs. (8.17)-(8.18): down = b_top + (b_top-b_bot)*g(u) with
            # u = -log(T_layer), g(u) = 1/u - 1/(1-exp(-u)). The reference's
            # direct form (irrad.F90:908-912) cancels catastrophically as
            # T->1; evaluate g via its series there (same limit, stable).
            yy = jnp.clip(layer_tran, 1e-5, 0.9999)
            u = -jnp.log(yy)
            w = 1.0 - yy
            g_direct = 1.0 / u - 1.0 / w
            g_series = -0.5 - u / 12.0 + (u * u * u) / 720.0
            g = jnp.where(u < 0.1, g_series, g_direct)
            down = blev[:-1] + (blev[:-1] - blev[1:]) * g
            return bsum - down, down      # up, down ; shape (nl,)

        ennb = enn[bi]
        bu_l, bd_l = emission((1.0 - ennb) * lay_tr)
        cu_l, cd_l = emission(lay_tr)
        if with_aerosol:
            du_l, dd_l = emission((1.0 - ennb) * lay_ta)
            au_l, ad_l = emission(lay_ta)
        else:
            du_l, dd_l = bu_l, bd_l
            au_l, ad_l = cu_l, cd_l

        bsfc = bs_b[bi]

        def up_down(up_lay, down_lay):
            up = jnp.concatenate([up_lay, bsfc[None]])      # index 0..np+1
            dwn = jnp.concatenate([down_lay, bsfc[None]])
            return up, dwn

        bu, bd = up_down(bu_l, bd_l)
        cu, cd = up_down(cu_l, cd_l)
        du_, dd = up_down(du_l, dd_l)
        au, ad = up_down(au_l, ad_l)

        # ---- flux accumulation over pairs (irrad.F90:1210-1277) ----
        w_all = jnp.where(tri, trant * fclr, 0.0)
        w_all_na = jnp.where(tri, taant * fclr, 0.0)
        w_clr = jnp.where(tri, trant, 0.0)
        w_clr_na = jnp.where(tri, taant, 0.0)

        def dvec_up(u):
            return u[:-1] - u[1:]       # d[k2-1] for k2=1..np+1 -> index k2

        def dvec_dn(d):
            return jnp.concatenate([-d[:1], d[:-2] - d[1:-1]])
            # index k1=0..np: k1=0 -> -bd(0); else bd(k1-1)-bd(k1)

        dbu = dvec_up(bu)  # length nl, entry j is the k2=j+1 term
        dcu = dvec_up(cu)
        ddu = dvec_up(du_)
        dau = dvec_up(au)

        def upsum(w, dx):
            # pair k2 axis is 0..np+1; k2>=1 contributes dx[k2-1]; the
            # upward flux is indexed by k1=0..np, pad level np+1 with 0
            s = (w[:, 1:] * dx[None, :]).sum(axis=1)
            return jnp.concatenate([s, jnp.zeros((1,), dtype)])

        flxu_b = upsum(w_all, dbu)
        flxau_b = upsum(w_all_na, ddu)
        flcu_b = upsum(w_clr, dcu)
        flau_b = upsum(w_clr_na, dau)

        dbd = dvec_dn(bd)
        dcd = dvec_dn(cd)
        ddd = dvec_dn(dd)
        dad = dvec_dn(ad)
        dnsum = lambda w, dx: (w * dx[:, None]).sum(axis=0)

        flxd_b = dnsum(w_all, dbd)
        flxad_b = dnsum(w_all_na, ddd)
        flcd_b = dnsum(w_clr, dcd)
        flad_b = dnsum(w_clr_na, dad)

        # boundary (k2 == k1+1) terms, bands != 10 (irrad.F90:1212-1221)
        if not b10:
            flxu_b = flxu_b - jnp.concatenate([bu[:-1], jnp.zeros((1,), dtype)])
            flxau_b = flxau_b - jnp.concatenate([du_[:-1], jnp.zeros((1,), dtype)])
            flcu_b = flcu_b - jnp.concatenate([cu[:-1], jnp.zeros((1,), dtype)])
            flau_b = flau_b - jnp.concatenate([au[:-1], jnp.zeros((1,), dtype)])
            flxd_b = flxd_b + jnp.concatenate([jnp.zeros((1,), dtype), bd[:-1]])
            flxad_b = flxad_b + jnp.concatenate([jnp.zeros((1,), dtype), dd[:-1]])
            flcd_b = flcd_b + jnp.concatenate([jnp.zeros((1,), dtype), cd[:-1]])
            flad_b = flad_b + jnp.concatenate([jnp.zeros((1,), dtype), ad[:-1]])

        # surface-to-level transmittances (irrad.F90:1279-1285)
        trantcr = jnp.concatenate([trant[:, -1], jnp.ones((1,), dtype)])
        trantca = jnp.concatenate([taant[:, -1], jnp.ones((1,), dtype)])
        transfc = jnp.concatenate([(trant * fclr)[:, -1],
                                   jnp.ones((1,), dtype)])
        transfca = jnp.concatenate([(taant * fclr)[:, -1],
                                    jnp.ones((1,), dtype)])

        # dfdts for levels 1..np (irrad.F90:1291-1293); all bands
        dbs = dbs_b[bi]
        lev_mask = jnp.concatenate(
            [jnp.zeros((1,), dtype), jnp.ones((nl - 1,), dtype),
             jnp.zeros((1,), dtype)])
        dfdts = dfdts - dbs * transfc * lev_mask

        if not b10:
            # surface emission & reflection (irrad.F90:1298-1319)
            flxu_b = flxu_b.at[-1].set(-bsfc)
            flxau_b = flxau_b.at[-1].set(-bsfc)
            flcu_b = flcu_b.at[-1].set(-bsfc)
            flau_b = flau_b.at[-1].set(-bsfc)
            sfcem = sfcem - bsfc
            dfdts = dfdts.at[-1].add(-dbs)

            rfl = rflxs_b[bi]
            refl_mask = jnp.concatenate(
                [jnp.zeros((1,), dtype), jnp.ones((nl,), dtype)])
            flau_b = flau_b - flad_b[-1] * trantca * rfl * refl_mask
            flcu_b = flcu_b - flcd_b[-1] * trantcr * rfl * refl_mask
            flxu_b = flxu_b - flxd_b[-1] * transfc * rfl * refl_mask
            flxau_b = flxau_b - flxad_b[-1] * transfca * rfl * refl_mask

        flxu = flxu + flxu_b
        flxau = flxau + flxau_b
        flcu = flcu + flcu_b
        flau = flau + flau_b
        flxd = flxd + flxd_b
        flxad = flxad + flxad_b
        flcd = flcd + flcd_b
        flad = flad + flad_b

    # drop the virtual index 0; model levels are 1..np+1
    out = dict(
        flxu=flxu[1:], flxd=flxd[1:], flcu=flcu[1:], flcd=flcd[1:],
        flau=flau[1:], flad=flad[1:], flxau=flxau[1:], flxad=flxad[1:],
        dfdts=dfdts[1:], sfcem=sfcem)
    return out


@partial(jax.jit, static_argnames=("ict", "icb", "trace", "with_aerosol"))
def chou_lw(ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4,
            cfc11, cfc12, cfc22, cwc, fcld, reff,
            taua=None, ssaa=None, asya=None, *,
            ict, icb, trace=True, with_aerosol=False):
    """Batched Chou-Suarez LW fluxes.

    Args:
      ple:   [ncol, np+1] level pressure (Pa), TOA..surface
      ta:    [ncol, np] layer temperature (K)
      wa:    [ncol, np] specific humidity (g/g)
      oa:    [ncol, np] ozone mass mixing ratio (g/g)
      tb:    [ncol] surface air temperature (K)
      ts:    [ncol] skin temperature (K)
      emis:  [ncol, 10] surface emissivity per band
      co2, n2o, ch4, cfc11, cfc12, cfc22: [ncol, np] volume mixing ratios
      cwc:   [ncol, np, 4] hydrometeor mixing ratios (ice, liq, rain, snow)
      fcld:  [ncol, np] cloud fraction
      reff:  [ncol, np, 4] effective radii (micron)
      taua/ssaa/asya: [ncol, np, 10] aerosol optics per band (optional)
      ict, icb: static level indices separating high/mid and mid/low clouds
                (1-based, matching the reference's LCLDMH/LCLDLM)
      trace: include trace gases (band 10, N2O/CH4/CFCs)

    Returns dict of [ncol, np+1] level fluxes (W/m^2; up negative, down
    positive): flxu/flxd (all-sky), flcu/flcd (clear), flau/flad (clear,
    no aerosol), flxau/flxad (all-sky, no aerosol), dfdts [ncol, np+1],
    sfcem [ncol].
    """
    ncol, np_ = ta.shape
    if taua is None:
        taua = jnp.zeros((ncol, np_, 10), ta.dtype)
        ssaa = jnp.zeros_like(taua)
        asya = jnp.zeros_like(taua)
    fn = partial(_chou_lw_column, ict=ict, icb=icb, trace=trace,
                 with_aerosol=with_aerosol)
    return jax.vmap(fn)(ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4,
                        cfc11, cfc12, cfc22, cwc, fcld, reff,
                        taua, ssaa, asya)
