#!/usr/bin/env python
"""Offline RRTMG g-point reduction: 16 g per band -> band-dependent count.

Re-implements (in vectorized numpy) the init-time reduction the reference
performs in rrtmg_lw_init.F90 (`lwcmbdat`/`cmbgb1..16`, rwgt at :120-141) and
rrtmg_sw_init.F90 (`swcmbdat`/`cmbgb16s..29`): absorption-coefficient-type
tables are combined with relative weights rwgt = wt(g)/sum_wt(group); source
and Planck-fraction tables are summed without weighting
(rrtmg_lw_init.F90:329+, rrtmg_sw_init.F90:463+).

Inputs: the raw per-band npz produced by extract_fortran_data.py.
Outputs: rrtmg_lw_reduced.npz / rrtmg_sw_reduced.npz with keys
"bandBB_<name>" (0-based numpy arrays, g axis LAST for all outputs).
"""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "geosradiation_gridcomp", "data")

# absorption-type tables: reduced with rwgt; raw g axis is LAST
WEIGHTED_GLAST = {"kao", "kbo", "selfrefo", "forrefo"}
# per-g spectral arrays: raw g axis FIRST
WEIGHTED_GFIRST = {"absco2o", "absh2oo",
                   "abso3ao", "abso3bo", "raylao", "raylbo", "raylo",
                   "ccl4o", "cfc11adjo", "cfc12o", "cfc22adjo", "absch4o", "abso2o"}
UNWEIGHTED_GFIRST = {"fracrefao", "fracrefbo", "sfluxrefo",
                     "irradnceo", "facbrghto", "snsptdrko"}

RENAME = {"kao": "ka", "kbo": "kb", "selfrefo": "selfref",
          "forrefo": "forref", "fracrefao": "fracrefa",
          "fracrefbo": "fracrefb", "sfluxrefo": "sfluxref",
          "irradnceo": "irradnce", "facbrghto": "facbrght",
          "snsptdrko": "snsptdrk", "absco2o": "absco2", "ccl4o": "ccl4", "cfc11adjo": "cfc11adj", "cfc12o": "cfc12", "cfc22adjo": "cfc22adj", "absch4o": "absch4", "abso2o": "abso2",
          "absh2oo": "absh2o", "abso3ao": "abso3a", "abso3bo": "abso3b",
          "raylao": "rayla", "raylbo": "raylb", "raylo": "rayl"}


def rename(name):
    if name in RENAME:
        return RENAME[name]
    if name.startswith("kao_"):
        return "ka_" + name[4:]
    if name.startswith("kbo_"):
        return "kb_" + name[4:]
    return name


def reduce_axis(arr, ngm_b, rwgt_b, axis, weighted):
    """Segment-reduce `arr` over 16 raw g-points along `axis`."""
    arr = np.moveaxis(arr, axis, -1)
    ngc = int(ngm_b.max())
    out = np.zeros(arr.shape[:-1] + (ngc,), dtype=np.float64)
    w = rwgt_b if weighted else np.ones(16)
    for ig in range(16):
        out[..., ngm_b[ig] - 1] += arr[..., ig] * w[ig]
    return out  # g axis last


def process(kind):
    """kind in {'lw','sw'}."""
    gmap = np.load(f"{DATA}/rrtmg_{kind}_gmap.npz")
    if kind == "lw":
        # wt lives in lw gmap (lwcmbdat); bands 1..16, file tag kgBB
        wt = gmap["wt"]
        bands = list(range(1, 17))
        tag = lambda b: f"rrtmg_lw_kg{b:02d}"
    else:
        cld = np.load(f"{DATA}/rrtmg_sw_cld.npz")
        wt = cld["wt"]
        bands = list(range(16, 30))
        tag = lambda b: f"rrtmg_sw_kg{b}"
    ngc = gmap["ngc"].astype(int) if "ngc" in gmap.files else None
    if ngc is None:
        ngc = np.load(f"{DATA}/rrtmg_sw_cld.npz")["ngc"].astype(int)
        ngm = np.load(f"{DATA}/rrtmg_sw_cld.npz")["ngm"].astype(int)
    else:
        ngm = gmap["ngm"].astype(int)

    out = {}
    for bi, b in enumerate(bands):
        ngm_b = ngm[bi * 16:(bi + 1) * 16]
        # rwgt for this band (rrtmg_lw_init.F90:120-141)
        if ngc[bi] < 16:
            wtsm = np.zeros(ngc[bi])
            for ig in range(16):
                wtsm[ngm_b[ig] - 1] += wt[ig]
            rwgt_b = wt / wtsm[ngm_b - 1]
        else:
            rwgt_b = np.ones(16)
        raw = np.load(f"{DATA}/{tag(b)}.npz")
        for name in raw.files:
            if name.endswith("__lo"):
                continue
            arr = np.asarray(raw[name], dtype=np.float64)
            if name in WEIGHTED_GLAST:
                red = reduce_axis(arr, ngm_b, rwgt_b, -1, True)
            elif name.startswith("kao_") or name.startswith("kbo_"):
                red = reduce_axis(arr, ngm_b, rwgt_b, -1, True)
            elif name in WEIGHTED_GFIRST:
                if arr.ndim == 0:   # scalar rayl
                    red = arr
                else:
                    red = reduce_axis(arr, ngm_b, rwgt_b, 0, True)
            elif name in UNWEIGHTED_GFIRST:
                red = reduce_axis(arr, ngm_b, rwgt_b, 0, False)
            elif name == "rayl":
                red = arr
            else:
                raise KeyError(f"unclassified table {name} in {tag(b)}")
            out[f"band{b:02d}_{rename(name)}"] = red
        print(f"band {b}: ngc={ngc[bi]} "
              + ",".join(f"{rename(n)}{np.shape(out[f'band{b:02d}_{rename(n)}'])}"
                         for n in raw.files if not n.endswith('__lo')))
    np.savez_compressed(f"{DATA}/rrtmg_{kind}_reduced.npz", **out)
    print(f"wrote rrtmg_{kind}_reduced.npz ({len(out)} arrays)")


if __name__ == "__main__":
    process("lw")
    process("sw")
