#!/usr/bin/env python
"""Extract QuickBeam/COSP numerical tables from the reference Fortran into
an npz artifact (same pattern as extract_fortran_data.py): the Liebe MPM
gas-absorption line tables (quickbeam/gases.f90), the GEOS hydrometeor
class table and the precip flux->mixing-ratio microphysics constants
(cosp_constants.F90). Run once; the artifact ships with the package."""

import os
import re
import sys

import numpy as np

REF = "/root/reference/GEOSsatsim_GridComp"
OUT = os.path.join(os.path.dirname(__file__), "..",
                   "geosradiation_gridcomp", "data", "quickbeam.npz")


def parse_data_statements(text, names):
    """Parse Fortran `data name/.../` statements (possibly multiline)."""
    # strip line continuations
    text = re.sub(r"&\s*\n\s*", " ", text)
    out = {}
    for name in names:
        m = re.search(rf"data\s+{name}\s*/(.*?)/", text,
                      re.IGNORECASE | re.DOTALL)
        if m is None:
            raise KeyError(name)
        vals = [v.strip() for v in m.group(1).replace("\n", " ").split(",")]
        out[name] = np.array([float(v) for v in vals if v])
    return out


def main():
    with open(os.path.join(REF, "quickbeam", "gases.f90")) as f:
        gases = f.read()
    g = parse_data_statements(
        gases, ["v0", "a1", "a2", "a3", "a4", "a5", "a6",
                "v1", "b1", "b2", "b3"])
    assert g["v0"].shape == (48,) and g["v1"].shape == (30,)

    with open(os.path.join(REF, "cosp_constants.F90")) as f:
        consts = f.read()
    # keep only the active (uncommented) DATA statements
    consts = "\n".join(l for l in consts.splitlines()
                       if not l.lstrip().startswith("!"))
    h = parse_data_statements(
        consts, ["HCLASS_TYPE", "HCLASS_PHASE", "HCLASS_DMIN",
                 "HCLASS_DMAX", "HCLASS_APM", "HCLASS_BPM", "HCLASS_RHO",
                 "HCLASS_P1", "HCLASS_P2", "HCLASS_P3",
                 "N_ax", "N_bx", "alpha_x", "c_x", "d_x", "g_x",
                 "a_x", "b_x", "gamma_1", "gamma_2", "gamma_3",
                 "gamma_4"])
    for k, v in h.items():
        assert v.shape == (9,), (k, v.shape)

    arrays = {"gas_" + k: v for k, v in g.items()}
    arrays.update({k.lower(): v for k, v in h.items()})
    np.savez_compressed(os.path.normpath(OUT), **arrays)
    print(f"wrote {os.path.normpath(OUT)}: {sorted(arrays)}")


if __name__ == "__main__":
    sys.exit(main())
