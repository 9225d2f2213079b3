"""RRTMG-SW table assembly (analog of tables_lw.py).

Flattens the reduced ka/kb tables to the reference's EQUIVALENCE layout for
flat-index gathers (rrtmg_sw_taumol.F90 ind0/ind1 arithmetic).
"""

import functools

import numpy as np

from ...tables import load

NG_SW = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]   # bands 16..29
NGS_SW = np.concatenate([[0], np.cumsum(NG_SW)])
NGPTSW = 112
NBNDSW = 14
# nspa/nspb for bands 16..29 (rrtmg_sw_init.F90:198-199)
NSPA = [9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1]
NSPB = [1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1]
# key-species ratios strrat (rrtmg_sw_taumol.F90, per band)
STRRAT = {16: 252.131, 17: 0.364641, 18: 38.9589, 19: 5.49281,
          21: 0.0045321, 22: 0.022708, 24: 0.124692, 28: 6.67029e-07}
LAYREFFR = {17: 30, 18: 6, 19: 3, 21: 8, 22: 2, 24: 1, 28: 42}
# bands whose solar-source reference layer is in the lower atmosphere
SOLFR_LOWER = {18, 19, 21, 22, 24}
SOLFR_UPPER = {17, 28}


def _flat(arr):
    ng = arr.shape[-1]
    return np.reshape(arr, (-1, ng), order="F")


@functools.lru_cache(maxsize=1)
def sw_tables():
    red = load("rrtmg_sw_reduced")
    ref = load("rrtmg_sw_ref")
    out = {"pref": ref["pref"], "preflog": ref["preflog"],
           "tref": ref["tref"]}
    for b in range(16, 30):
        p = f"band{b:02d}_"
        d = {k[len(p):]: red[k] for k in red if k.startswith(p)}
        tabs = {}
        if "ka" in d:
            tabs["absa"] = _flat(d["ka"])
        if "kb" in d:
            tabs["absb"] = _flat(d["kb"])
        for k, v in d.items():
            if k not in ("ka", "kb"):
                tabs[k] = v
        out[b] = tabs
    return out


# ---------------------------------------------------------------------------
# Gather layout (same design as tables_lw.lw_gather_tables_padded):
# one combined [300, 1280] table, 4 shared row-gathers per (column, layer),
# eta planes in 128-lane-aligned sections, regime folded into the row index.
# See taumol_lw.py's banner comment for the rationale.
# ---------------------------------------------------------------------------

SW2_BANDS = [16, 17, 18, 19, 21, 22, 24, 28]       # two-key lower
SWS_BANDS = [20, 23, 25, 27, 29]                   # single-key lower
SW2_NG = [NG_SW[b - 16] for b in SW2_BANDS]        # sum = 60
SWS_NG = [NG_SW[b - 16] for b in SWS_BANDS]        # sum = 46
SW2_W = int(np.sum(SW2_NG))
SWS_W = int(np.sum(SWS_NG))
SW2_OFF = dict(zip(SW2_BANDS, np.concatenate([[0], np.cumsum(SW2_NG)[:-1]])))
SWS_OFF = dict(zip(SWS_BANDS, np.concatenate([[0], np.cumsum(SWS_NG)[:-1]])))
SW_NROW_LOWER = 65
SW_NROWS = 300
SW_SPP = 128
SW_SSP = 128
SW_BIG_W = 9 * SW_SPP + SW_SSP                     # 1280

# lower-atmosphere key-species pair per two-key band (gas1, gas2, strrat)
SW_PAIR = {16: ("h2o", "ch4", 252.131), 17: ("h2o", "co2", 0.364641),
           18: ("h2o", "ch4", 38.9589), 19: ("h2o", "co2", 5.49281),
           21: ("h2o", "co2", 0.0045321), 22: ("h2o", "o2", 1.6 * 0.022708),
           24: ("h2o", "o2", 0.124692), 28: ("o3", "o2", 6.67029e-07)}
# stratosphere: two-key spec4 bands and single-key column gas
SW_UPPER2 = {17: ("h2o", "co2", 0.364641), 21: ("h2o", "co2", 0.0045321),
             28: ("o3", "o2", 6.67029e-07)}
SW_UPPER1 = {16: "ch4", 18: "ch4", 19: "co2", 20: "h2o", 22: "o2x",
             24: "o2", 27: "o3", 29: "co2"}
SW_LOWER1 = {20: "h2o", 23: "h2o", 25: "h2o", 27: "o3", 29: "h2o"}
# regime applicability of the (colh2o-scaled) self/foreign continua
SW_SELF_LO = {16, 17, 18, 19, 20, 21, 22, 23, 24, 29}
SW_FOR_HI = {17, 20, 21}


@functools.lru_cache(maxsize=1)
def sw_gather_tables():
    t = sw_tables()
    big = np.zeros((SW_NROWS, SW_BIG_W), np.float32)

    def row_lo(jp0, jt0):
        return 5 * jp0 + jt0

    def row_up(jpu, jt0):
        return SW_NROW_LOWER + 5 * jpu + jt0

    for b in SW2_BANDS:
        ng = NG_SW[b - 16]
        off = SW2_OFF[b]
        absa = t[b]["absa"].reshape(13, 5, 9, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                for e in range(9):
                    big[row_lo(jp0, jt0),
                        e * SW_SPP + off: e * SW_SPP + off + ng] = \
                        absa[jp0, jt0, e]
        if b in SW_UPPER2:
            absb = t[b]["absb"].reshape(47, 5, 5, ng)
            for jpu in range(47):
                for jt0 in range(5):
                    for e in range(5):
                        big[row_up(jpu, jt0),
                            e * SW_SPP + off: e * SW_SPP + off + ng] = \
                            absb[jpu, jt0, e]
        elif b in SW_UPPER1:
            absb = t[b]["absb"].reshape(47, 5, ng)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = absb[jpu, jt0]

    for b in SWS_BANDS:
        ng = NG_SW[b - 16]
        off = 9 * SW_SPP + SWS_OFF[b]
        scale = 1.029 if b == 23 else 1.0          # givfac, taumol.F90 band 23
        absa = t[b]["absa"].reshape(13, 5, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                big[row_lo(jp0, jt0), off: off + ng] = absa[jp0, jt0] * scale
        if "absb" in t[b]:
            absb = t[b]["absb"].reshape(47, 5, ng)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = absb[jpu, jt0]

    seg_sw2 = np.zeros((len(SW2_BANDS), SW_SPP), np.float32)
    for i, b in enumerate(SW2_BANDS):
        seg_sw2[i, SW2_OFF[b]: SW2_OFF[b] + NG_SW[b - 16]] = 1.0
    seg_sws = np.zeros((len(SWS_BANDS), SW_SSP), np.float32)
    for i, b in enumerate(SWS_BANDS):
        seg_sws[i, SWS_OFF[b]: SWS_OFF[b] + NG_SW[b - 16]] = 1.0
    scat_sw2 = np.zeros((SW_SPP, NGPTSW), np.float32)
    for b in SW2_BANDS:
        for g in range(NG_SW[b - 16]):
            scat_sw2[SW2_OFF[b] + g, NGS_SW[b - 16] + g] = 1.0
    scat_sws = np.zeros((SW_SSP, NGPTSW), np.float32)
    for b in SWS_BANDS:
        for g in range(NG_SW[b - 16]):
            scat_sws[SWS_OFF[b] + g, NGS_SW[b - 16] + g] = 1.0

    # self/foreign stacks over all 112 g (zero where a band lacks a table;
    # 3-row forref tables padded to 4 rows - only ever indexed at rows 1-3
    # in the troposphere, and none of those bands has stratospheric for)
    self10 = np.zeros((10, NGPTSW), np.float32)
    for4 = np.zeros((4, NGPTSW), np.float32)
    for b in range(16, 30):
        sl = slice(NGS_SW[b - 16], NGS_SW[b - 15])
        if "selfref" in t[b]:
            self10[:, sl] = t[b]["selfref"]
        if "forref" in t[b]:
            fr = t[b]["forref"]
            for4[:fr.shape[0], sl] = fr

    def bvec(vals):
        v = np.zeros(NGPTSW, np.float32)
        for b, val in vals.items():
            v[NGS_SW[b - 16]:NGS_SW[b - 15]] = val
        return v

    # gray absorber static vectors + per-g Rayleigh
    gray = {
        "ch4_both": bvec({20: t[20]["absch4"]}),
        "o3_lo": bvec({24: t[24]["abso3a"], 25: t[25]["abso3a"]}),
        "o3_hi": bvec({24: t[24]["abso3b"], 25: t[25]["abso3b"]}),
        "co2_lo": bvec({29: t[29]["absco2"]}),
        "h2o_hi": bvec({29: t[29]["absh2o"]}),
        "o2cont": bvec({22: 4.35e-4 / (350.0 * 2.0)}),
    }
    raylvec = np.zeros(NGPTSW, np.float32)
    for b in range(16, 30):
        if b == 24:
            continue                                # eta-interpolated below
        r = t[b].get("rayl")
        if r is not None:
            raylvec[NGS_SW[b - 16]:NGS_SW[b - 15]] = r
    rayla24 = t[24]["rayla"]                        # (9, 8)
    raylb24 = bvec({24: t[24]["raylb"]})
    scat_b24 = np.zeros((8, NGPTSW), np.float32)
    scat_b24[:, NGS_SW[8]:NGS_SW[9]] = np.eye(8, dtype=np.float32)
    mask_self_lo = bvec({b: 1.0 for b in SW_SELF_LO})
    mask_for_hi = bvec({b: 1.0 for b in SW_FOR_HI})
    return {"big": big, "seg_sw2": seg_sw2, "seg_sws": seg_sws,
            "scat_sw2": scat_sw2, "scat_sws": scat_sws,
            "self10": self10, "for4": for4, "gray": gray,
            "raylvec": raylvec, "rayla24": rayla24, "raylb24": raylb24,
            "scat_b24": scat_b24, "mask_self_lo": mask_self_lo,
            "mask_for_hi": mask_for_hi}
