"""RRTMG-LW table assembly: reduced k-tables flattened to gather layout.

The reduced per-band npz (tools/reduce_rrtmg_g.py) stores ka as
(neta, 5, 13, ng) / kb as (neta, 5, 47, ng) in the reference's Fortran
dimension order. The taumol interpolation indexes the EQUIVALENCEd flat
arrays absa(585, ng)/absb(1175, ng) with
ind = ((jp-1)*5 + (jt-1))*nspa + js  (rrtmg_lw_taumol.F90:226-228 etc.),
i.e. column-major flattening over (eta, jt, jp). We reproduce exactly that
layout with an order='F' reshape so the +/-1, +8..+11 eta-straddling offsets
of the 0.125/0.875 special interpolation match the reference bit-for-bit.
"""

import functools

import numpy as np

from ...tables import load

NG_LW = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
NGS_LW = np.concatenate([[0], np.cumsum(NG_LW)])  # g offsets per band
NGPTLW = 140
NBNDLW = 16
# nspa/nspb from lwdatinit (rrtmg_lw_init.F90:193-195)
NSPA = [1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9]
NSPB = [1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0]


def _flat(arr):
    """(eta?, jt, jp, ng) -> (eta*jt*jp, ng) column-major (Fortran flat)."""
    ng = arr.shape[-1]
    return np.reshape(arr, (-1, ng), order="F")


@functools.lru_cache(maxsize=1)
def lw_tables():
    """Returns dict: band index (1-based) -> dict of numpy float32 tables."""
    red = load("rrtmg_lw_reduced")
    ref = load("rrtmg_lw_ref")
    out = {"chi_mls": ref["chi_mls"],           # (7, 59)
           "pref": ref["pref"], "preflog": ref["preflog"],
           "tref": ref["tref"],
           "totplnk": ref["totplnk"],           # (181, 16)
           "totplk16": ref["totplk16"],
           "totplnkderiv": ref["totplnkderiv"],
           "totplk16deriv": ref["totplk16deriv"]}
    for b in range(1, 17):
        p = f"band{b:02d}_"
        d = {}
        for k in red:
            if k.startswith(p):
                d[k[len(p):]] = red[k]
        tabs = {}
        if "ka" in d:
            tabs["absa"] = _flat(d["ka"])
        if "kb" in d:
            tabs["absb"] = _flat(d["kb"])
        for k, v in d.items():
            if k in ("ka", "kb"):
                continue
            tabs[k] = v
        out[b] = tabs
    return out


# ---------------------------------------------------------------------------
# Gather layout: one combined major-k table, 4 row-gathers per cell.
#
# The taumol major-species interpolation (rrtmg_lw_taumol.F90, every band's
# ind0/ind1 block) touches, per (column, layer), exactly four (jp', jt')
# table blocks: (jp,jt), (jp,jt+1), (jp+1,jt1), (jp+1,jt1+1). The fast
# layout packs EVERY band's eta block for one (regime, jp', jt') into a
# single wide row, so four row-gathers serve all bands:
#
#   BIGTAB[row, lane]:
#     row   = 5*(jp-1) + (jt-1)                 for tropospheric (absa) rows
#           = 65 + 5*(jp-13) + (jt-1)           for stratospheric (absb) rows
#     lanes = [e*86 + sp2_offset(band) + g]     9 eta planes x 86 two-key g's
#             [774 + ss_offset(band) + g]       54 single-key g's (no eta)
#
# The troposphere/stratosphere split (laytrop) is folded into the ROW INDEX,
# so lower and upper atmosphere cost one shared gather instead of the 2x
# dense compute of the per-band engine. Stratospheric rows store absb with
# its 5 eta points in planes 0-4 (planes 5-8 zero); single-key-upper bands
# (7, 9, 16) store kb in plane 0 of their sp2 section.
# ---------------------------------------------------------------------------

SP2_BANDS = [3, 4, 5, 7, 9, 12, 13, 15, 16]
SS_BANDS = [1, 2, 6, 8, 10, 11, 14]
SP2_NG = [NG_LW[b - 1] for b in SP2_BANDS]        # sum = 86
SS_NG = [NG_LW[b - 1] for b in SS_BANDS]          # sum = 54
SP2_W = int(np.sum(SP2_NG))
SS_W = int(np.sum(SS_NG))
SP2_OFF = dict(zip(SP2_BANDS, np.concatenate([[0], np.cumsum(SP2_NG)[:-1]])))
SS_OFF = dict(zip(SS_BANDS, np.concatenate([[0], np.cumsum(SS_NG)[:-1]])))
NROW_LOWER = 65            # 13 jp x 5 jt
NROWS = 300                # + 47 jp x 5 jt
BIG_W = 9 * SP2_W + SS_W   # 828

# empirical stratospheric per-g scale tweaks, applied to kb at build time
# (rrtmg_lw_taumol.F90:948-954 band 4, :1323-1329 band 7)
_B4_SCALE = np.ones(14, np.float32)
_B4_SCALE[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
_B7_SCALE = np.ones(12, np.float32)
_B7_SCALE[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]


@functools.lru_cache(maxsize=1)
def lw_gather_tables():
    """Build the combined gather tables (numpy, cached)."""
    t = lw_tables()
    big = np.zeros((NROWS, BIG_W), np.float32)

    def row_lo(jp0, jt0):     # jp0 in [0,13), jt0 in [0,5)
        return 5 * jp0 + jt0

    def row_up(jpu, jt0):     # jpu in [0,47)
        return NROW_LOWER + 5 * jpu + jt0

    for b in SP2_BANDS:
        ng = NG_LW[b - 1]
        off = SP2_OFF[b]
        ka = t[b]["absa"].reshape(13, 5, 9, ng, order="C") \
            if False else None
        # absa flat rows are 45*(jp-1)+9*(jt-1)+(js-1): recover the cube
        absa = t[b]["absa"].reshape(13, 5, 9, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                for e in range(9):
                    big[row_lo(jp0, jt0), e * SP2_W + off: e * SP2_W + off + ng] = \
                        absa[jp0, jt0, e]
        if b in (3, 4, 5):     # two-key stratosphere, 5 eta points
            absb = t[b]["absb"].reshape(47, 5, 5, ng)
            scale = _B4_SCALE if b == 4 else np.ones(ng, np.float32)
            for jpu in range(47):
                for jt0 in range(5):
                    for e in range(5):
                        big[row_up(jpu, jt0), e * SP2_W + off: e * SP2_W + off + ng] = \
                            absb[jpu, jt0, e] * scale
        elif b in (7, 9, 16):  # single-key stratosphere in eta plane 0
            absb = t[b]["absb"].reshape(47, 5, ng)
            scale = _B7_SCALE if b == 7 else np.ones(ng, np.float32)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = \
                        absb[jpu, jt0] * scale
        # bands 12, 13, 15: no stratospheric k contribution -> zeros

    for b in SS_BANDS:
        ng = NG_LW[b - 1]
        off = 9 * SP2_W + SS_OFF[b]
        absa = t[b]["absa"].reshape(13, 5, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                big[row_lo(jp0, jt0), off: off + ng] = absa[jp0, jt0]
        if "absb" in t[b]:     # band 6 has none
            absb = t[b]["absb"].reshape(47, 5, ng)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = absb[jpu, jt0]

    # self/foreign continua stacked over all bands in g order
    self10 = np.concatenate([t[b]["selfref"] for b in range(1, 17)], axis=1)
    for4 = np.concatenate([t[b]["forref"] for b in range(1, 17)], axis=1)
    return {"big": big, "self10": self10, "for4": for4}


# ---------------------------------------------------------------------------
# Lane-aligned variant: each eta plane padded to a 128-lane section so every
# per-eta slice of the gathered row is 128-aligned (unaligned slices make
# XLA insert layout copies of the gathered rows). Static 0/1
# segment/scatter matrices apply per-band weights and reassemble
# band-ordered g vectors as matmuls, keeping the whole epilogue free of
# sub-128 concats.
# ---------------------------------------------------------------------------

SPP = 128                     # padded width of one eta section
SSP = 64                      # padded width of the single-key section
BIG_PW = 9 * SPP + SSP        # 1216


@functools.lru_cache(maxsize=1)
def lw_gather_tables_padded():
    gt = lw_gather_tables()
    big = gt["big"]
    bigp = np.zeros((NROWS, BIG_PW), np.float32)
    for e in range(9):
        bigp[:, e * SPP: e * SPP + SP2_W] = big[:, e * SP2_W:(e + 1) * SP2_W]
    bigp[:, 9 * SPP: 9 * SPP + SS_W] = big[:, 9 * SP2_W:]

    # segment matrices: band weight -> lane span
    seg_sp2 = np.zeros((len(SP2_BANDS), SPP), np.float32)
    for i, b in enumerate(SP2_BANDS):
        seg_sp2[i, SP2_OFF[b]: SP2_OFF[b] + NG_LW[b - 1]] = 1.0
    seg_ss = np.zeros((len(SS_BANDS), SSP), np.float32)
    for i, b in enumerate(SS_BANDS):
        seg_ss[i, SS_OFF[b]: SS_OFF[b] + NG_LW[b - 1]] = 1.0

    # scatter matrices: section lane -> band-ordered g-point
    scat_sp2 = np.zeros((SPP, NGPTLW), np.float32)
    for b in SP2_BANDS:
        for g in range(NG_LW[b - 1]):
            scat_sp2[SP2_OFF[b] + g, NGS_LW[b - 1] + g] = 1.0
    scat_ss = np.zeros((SSP, NGPTLW), np.float32)
    for b in SS_BANDS:
        for g in range(NG_LW[b - 1]):
            scat_ss[SS_OFF[b] + g, NGS_LW[b - 1] + g] = 1.0

    return {"big": bigp, "seg_sp2": seg_sp2, "seg_ss": seg_ss,
            "scat_sp2": scat_sp2, "scat_ss": scat_ss,
            "self10": gt["self10"], "for4": gt["for4"]}


def band_vector(vals_by_band):
    """Static [140] vector with vals_by_band[b] (scalar or len-ng array)
    placed on band b's g-points, zeros elsewhere."""
    v = np.zeros(NGPTLW, np.float32)
    for b, val in vals_by_band.items():
        v[NGS_LW[b - 1]:NGS_LW[b]] = val
    return v


def stack_sections(tabs):
    """Stack per-section (K, ng) tables along lanes; returns (stacked,
    seg [nsec, W], scat [W, 140]) given a list of (band, tab) pairs."""
    W = sum(t.shape[-1] for _, t in tabs)
    K = tabs[0][1].shape[0]
    stacked = np.zeros((K,) + ((W,) if tabs[0][1].ndim == 2 else ()),
                       np.float32)
    stacked = np.concatenate([t for _, t in tabs], axis=-1)
    seg = np.zeros((len(tabs), W), np.float32)
    scat = np.zeros((W, NGPTLW), np.float32)
    off = 0
    for i, (b, t) in enumerate(tabs):
        ng = t.shape[-1]
        seg[i, off:off + ng] = 1.0
        for g in range(ng):
            scat[off + g, NGS_LW[b - 1] + g] = 1.0
        off += ng
    return stacked, seg, scat
