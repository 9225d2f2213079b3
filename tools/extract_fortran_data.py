#!/usr/bin/env python
"""Extract numerical data tables from the reference Fortran sources into .npz.

The reference (GEOS-ESM/GEOSradiation_GridComp) carries ~150 kLoC of numerical
data as Fortran DATA statements, declaration initializers, and array-slice
assignments (see SURVEY.md "The 150 kLoC of data"). This tool parses those
statements generically and assembles numpy arrays, so no number is ever
hand-ported.

Handled statement forms (after continuation joining):
  real, dimension(3,10) :: name = reshape([v1, v2, ...], [3,10])
  real, dimension(5)    :: name = [v1, ...]        (or (/ ... /))
  real :: name = 1.23e-4
  name = 1.23e-4
  name(:) = (/ ... /)
  name(:, 2, 13) = (/ ... /)                       (slice at any position)
  name(1:50, 3)  = (/ ... /)                       (range slices)
  data name / v1, v2, ... /                        (incl. repeat counts n*v)

Arrays are stored with the Fortran dimension ORDER preserved (index i of the
Fortran declaration == axis i of the numpy array), values laid out per the
source's column-major semantics. Lower bounds other than 1 (e.g. kbo(5,13:59,16))
are normalized to 0; the original lower bound is recorded in `<name>__lo`.
"""

import os
import re
import sys
import numpy as np

NUM_RE = re.compile(
    r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[edED][+-]?\d+)?(?:_\w+)?"
)


def _strip_comment(line: str) -> str:
    # no quoted strings matter in data statements; cut at first '!'
    i = line.find("!")
    return line if i < 0 else line[:i]


def join_statements(text: str, fixed_form: bool = False):
    """Yield logical statements with continuations joined."""
    out = []
    cur = ""
    for raw in text.splitlines():
        line = _strip_comment(raw.rstrip("\n"))
        if not line.strip():
            continue
        if fixed_form:
            if len(line) > 6 and line[5] not in " 0" and line[:5].strip() == "":
                cur += " " + line[6:]
                continue
            if cur:
                out.append(cur)
            cur = line[6:] if len(line) > 6 else line
        else:
            s = line.strip()
            if cur.endswith("&"):
                cur = cur[:-1].rstrip()
                if s.startswith("&"):
                    s = s[1:]
                cur += " " + s
            else:
                if cur:
                    out.append(cur)
                cur = s
    if cur:
        out.append(cur)
    return out


def parse_numbers(s: str):
    vals = []
    # handle repeat counts like 62*0.0  (DATA statements)
    for tok in s.replace("(/", " ").replace("/)", " ").split(","):
        tok = tok.strip()
        if not tok:
            continue
        m = re.fullmatch(r"(\d+)\s*\*\s*(.+)", tok)
        if m:
            n = int(m.group(1))
            v = _one_number(m.group(2))
            vals.extend([v] * n)
        else:
            v = _one_number(tok)
            if v is not None:
                vals.append(v)
    return vals


def _one_number(tok: str):
    tok = tok.strip()
    m = NUM_RE.fullmatch(tok)
    if not m:
        m2 = NUM_RE.search(tok)
        if m2 and m2.group(0) == tok[m2.start():].strip():
            m = m2
        else:
            return None
    t = m.group(0)
    t = re.sub(r"_\w+$", "", t)
    t = t.replace("d", "e").replace("D", "e").replace("E", "e")
    return float(t)


DECL_RE = re.compile(
    r"^(?:real|integer|double\s+precision)\s*(?:\([^)]*\))?\s*"
    r"(?:,\s*(?:parameter|save)\s*)*"
    r"(?:,\s*dimension\s*\(([^)]*)\)\s*)?"
    r"(?:,\s*(?:parameter|save)\s*)*"
    r"::\s*(\w+)\s*(?:\(([^)]*)\))?\s*=\s*(.+)$",
    re.IGNORECASE,
)
SLICE_RE = re.compile(r"^(\w+)\s*\(([^)]*)\)\s*=\s*(.+)$")
SCALAR_RE = re.compile(r"^(\w+)\s*=\s*([^,()]+)$")
DATA_RE = re.compile(r"^data\s+(\w+)\s*/(.*)/\s*$", re.IGNORECASE)
DATA_IDX_RE = re.compile(r"^data\s+(\w+)\s*\(([^)]*)\)\s*/(.*)/\s*$", re.IGNORECASE)


class Collector:
    """Accumulates slice assignments and assembles arrays."""

    def __init__(self):
        self.pieces = {}   # name -> list[(idx_spec, values)]
        self.full = {}     # name -> np.ndarray (complete on arrival)
        self.scalars = {}

    def add_full(self, name, arr):
        self.full[name.lower()] = arr

    def add_scalar(self, name, val):
        self.scalars[name.lower()] = val

    def add_slice(self, name, idx_spec, values):
        self.pieces.setdefault(name.lower(), []).append((idx_spec, values))

    def assemble(self):
        out = dict(self.full)
        lo_bounds = {}
        for name, pieces in self.pieces.items():
            ndim = len(pieces[0][0])
            mins = [None] * ndim
            maxs = [None] * ndim
            for idx, vals in pieces:
                assert len(idx) == ndim, f"{name}: inconsistent rank"
                open_dims = [d for d, s in enumerate(idx) if s == ":"]
                # infer open slice length
                known = 1
                for d, s in enumerate(idx):
                    if isinstance(s, tuple):
                        known *= s[1] - s[0] + 1
                if open_dims:
                    assert len(open_dims) == 1, f"{name}: >1 open slice"
                    open_len = len(vals) // known
                for d, s in enumerate(idx):
                    if s == ":":
                        lo, hi = 1, open_len
                    elif isinstance(s, tuple):
                        lo, hi = s
                    else:
                        lo = hi = s
                    mins[d] = lo if mins[d] is None else min(mins[d], lo)
                    maxs[d] = hi if maxs[d] is None else max(maxs[d], hi)
            shape = tuple(maxs[d] - mins[d] + 1 for d in range(ndim))
            arr = np.full(shape, np.nan, dtype=np.float64)
            for idx, vals in pieces:
                sub_slices = []
                sub_shape = []
                for d, s in enumerate(idx):
                    if s == ":":
                        lo, hi = mins[d], mins[d] + len(vals) // max(
                            1, int(np.prod([t[1] - t[0] + 1 for t in idx if isinstance(t, tuple)]))) - 1
                        # recompute properly below
                    if s == ":":
                        known = 1
                        for t in idx:
                            if isinstance(t, tuple):
                                known *= t[1] - t[0] + 1
                        lo, hi = 1, len(vals) // known
                    elif isinstance(s, tuple):
                        lo, hi = s
                    else:
                        lo = hi = s
                    sub_slices.append(slice(lo - mins[d], hi - mins[d] + 1))
                    sub_shape.append(hi - lo + 1)
                block = np.asarray(vals, dtype=np.float64).reshape(
                    tuple(sub_shape), order="F")
                arr[tuple(sub_slices)] = block
            if np.isnan(arr).any():
                n = int(np.isnan(arr).sum())
                print(f"  WARNING: {name}: {n}/{arr.size} entries unfilled")
            out[name] = arr
            lo_bounds[name] = np.asarray(mins, dtype=np.int64)
        for name, mins in lo_bounds.items():
            if (mins != 1).any():
                out[name + "__lo"] = mins
        for name, v in self.scalars.items():
            if name not in out:
                out[name] = np.float64(v)
        return out


def _parse_idx(spec: str):
    idx = []
    for part in spec.split(","):
        part = part.strip()
        if part == ":":
            idx.append(":")
        elif ":" in part:
            lo, hi = part.split(":")
            idx.append((int(lo), int(hi)))
        else:
            try:
                idx.append(int(part))
            except ValueError:
                return None  # symbolic index (e.g. 5:maxinpx) — skip
    return tuple(idx)


def extract_file(path: str, only=None, fixed_form=None):
    """Parse one Fortran file; return dict of arrays/scalars.

    only: optional set of lowercase names to keep (None = all).
    """
    if fixed_form is None:
        fixed_form = path.endswith(".f") or path.endswith(".code")
    with open(path, "r", errors="replace") as f:
        text = f.read()
    col = Collector()
    for st in join_statements(text, fixed_form=fixed_form):
        low = st.lower()
        m = DECL_RE.match(st)
        if m:
            dims, name, dims2, rhs = m.groups()
            if only and name.lower() not in only:
                continue
            dims = dims or dims2
            rhs = rhs.strip()
            rm = re.match(r"reshape\s*\(\s*[\[(]/?(.*?)/?[\])]\s*,\s*[\[(]/?\s*([\d,\s]+)\s*/?[\])]\s*\)\s*$",
                          rhs, re.IGNORECASE | re.DOTALL)
            if rm:
                vals = parse_numbers(rm.group(1))
                shape = tuple(int(x) for x in rm.group(2).split(","))
                col.add_full(name, np.asarray(vals).reshape(shape, order="F"))
            elif rhs.startswith("[") or rhs.startswith("(/"):
                vals = parse_numbers(rhs.strip("[]").replace("(/", "").replace("/)", ""))
                col.add_full(name, np.asarray(vals))
            else:
                v = _one_number(rhs)
                if v is not None:
                    col.add_scalar(name, v)
            continue
        m = DATA_IDX_RE.match(st)
        if m:
            name, spec, body = m.groups()
            if only and name.lower() not in only:
                continue
            idx = _parse_idx(spec)
            if idx is not None:
                col.add_slice(name, idx, parse_numbers(body))
            continue
        m = DATA_RE.match(st)
        if m:
            name, body = m.groups()
            if only and name.lower() not in only:
                continue
            col.add_full(name, np.asarray(parse_numbers(body)))
            continue
        m = SLICE_RE.match(st)
        if m and ("(/" in st or "[" in st.split("=", 1)[1]):
            name, spec, rhs = m.groups()
            if only and name.lower() not in only:
                continue
            idx = _parse_idx(spec)
            if idx is None:
                continue
            vals = parse_numbers(rhs)
            if vals:
                col.add_slice(name, idx, vals)
            continue
        m = SCALAR_RE.match(st)
        if m:
            name, rhs = m.groups()
            if only and name.lower() not in only:
                continue
            if name.lower() in ("if", "do", "end", "call", "use", "save",
                                "return", "implicit"):
                continue
            v = _one_number(rhs)
            if v is not None:
                col.add_scalar(name, v)
            continue
    return col.assemble()


REF = "/root/reference"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "geosradiation_gridcomp", "data")


def run_all():
    import os
    os.makedirs(OUT, exist_ok=True)

    jobs = {
        # Chou-Suarez tables
        "chou_sorad_constants": (
            f"{REF}/GEOSsolar_GridComp/soradconstants.F90", None),
        "chou_irrad_constants": (
            f"{REF}/GEOSirrad_GridComp/irradconstants.F90", None),
        "chou_rad_constants": (
            f"{REF}/GEOS_RadiationShared/radconstants.F90", None),
        # condensate inhomogeneity xcw tables (1000 x 140, beta & gamma)
    }
    for tag, (path, only) in jobs.items():
        print(f"== {tag}: {path}")
        d = extract_file(path, only=only)
        for k, v in sorted(d.items()):
            print(f"   {k}: {np.shape(v)}")
        np.savez_compressed(f"{OUT}/{tag}.npz", **d)

    # xcw tables: two subroutines fill the same array; split by subroutine
    path = f"{REF}/GEOS_RadiationShared/cloud_condensate_inhomogeneity.F90"
    text = open(path).read()
    parts = {}
    for mode in ("beta", "gamma"):
        mm = re.search(rf"subroutine tabulate_xcw_{mode}(.*?)end subroutine",
                       text, re.DOTALL)
        col = Collector()
        for st in join_statements(mm.group(1)):
            m = SLICE_RE.match(st)
            if m and "(/" in st:
                idx = _parse_idx(m.group(2))
                if idx:
                    col.add_slice(m.group(1), idx, parse_numbers(m.group(3)))
        arr = col.assemble()["xcw"]
        parts[f"xcw_{mode}"] = arr
        print(f"== xcw_{mode}: {arr.shape}")
    np.savez_compressed(f"{OUT}/chou_xcw_inhomogeneity.npz", **parts)

    # RRTMG LW: k_g data per band + setcoef reference atmosphere + planck
    lw = f"{REF}/GEOSirrad_GridComp/RRTMG/rrtmg_lw/gcm_model"
    for band in range(1, 17):
        p = f"{lw}/src/rrtmg_lw_k_g_{band:02d}.F90"
        print(f"== rrtmg_lw_kg{band:02d}")
        d = extract_file(p)
        for k, v in sorted(d.items()):
            print(f"   {k}: {np.shape(v)}")
        np.savez_compressed(f"{OUT}/rrtmg_lw_kg{band:02d}.npz", **d)
    print("== rrtmg_lw_ref (pref/tref/chi_mls/totplnk)")
    d = extract_file(f"{lw}/src/rrtmg_lw_setcoef.F90",
                     only={"pref", "preflog", "tref", "chi_mls",
                           "totplnk", "totplk16", "totplnkderiv",
                           "totplk16deriv"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_lw_ref.npz", **d)
    print("== rrtmg_lw_cld (cloud optics tables)")
    d = extract_file(f"{lw}/src/rrtmg_lw_init.F90",
                     only={"absliq1", "absice0", "absice1", "absice2",
                           "absice3", "absice4"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_lw_cld.npz", **d)

    # RRTMG SW
    sw = f"{REF}/GEOSsolar_GridComp/RRTMG/rrtmg_sw/gcm_model"
    for band in range(16, 30):
        p = f"{sw}/src/rrtmg_sw_k_g_{band}.F90"
        print(f"== rrtmg_sw_kg{band}")
        d = extract_file(p)
        for k, v in sorted(d.items()):
            print(f"   {k}: {np.shape(v)}")
        np.savez_compressed(f"{OUT}/rrtmg_sw_kg{band}.npz", **d)
    print("== rrtmg_sw_ref")
    d = extract_file(f"{sw}/src/rrtmg_sw_setcoef.F90",
                     only={"pref", "preflog", "tref"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_sw_ref.npz", **d)
    print("== rrtmg_sw_cld + solar source etc. from init")
    d = extract_file(f"{sw}/src/rrtmg_sw_init.F90",
                     only={"extliq1", "ssaliq1", "asyliq1",
                           "extice2", "ssaice2", "asyice2",
                           "extice3", "ssaice3", "asyice3", "fdlice3",
                           "abari", "bbari", "cbari", "dbari", "ebari", "fbari",
                           "wavenum1", "wavenum2", "delwave",
                           "rsrtaua", "rsrpiza", "rsrasya", "icxa",
                           "ngc", "ngs", "ngm", "ngn", "ngb", "wt", "rwgt"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_sw_cld.npz", **d)

    # LW init: g-reduction mapping + weights
    print("== rrtmg_lw_gmap")
    d = extract_file(f"{lw}/src/rrtmg_lw_init.F90",
                     only={"ngc", "ngs", "ngm", "ngn", "ngb", "wt", "rwgt",
                           "ng", "nspa", "nspb"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_lw_gmap.npz", **d)

    # SW init spectral metadata from module parrrsw / rrtmg_sw_init (ng, nspa, nspb)
    print("== rrtmg_sw_gmap")
    d = extract_file(f"{sw}/src/rrtmg_sw_init.F90",
                     only={"ng", "nspa", "nspb"})
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/rrtmg_sw_gmap.npz", **d)

    # NRLSSI2 solar variability tables
    print("== nrlssi2")
    d = extract_file(f"{sw}/src/NRLSSI2.F90")
    for k, v in sorted(d.items()):
        print(f"   {k}: {np.shape(v)}")
    np.savez_compressed(f"{OUT}/nrlssi2.npz", **d)


if __name__ == "__main__":
    run_all()
