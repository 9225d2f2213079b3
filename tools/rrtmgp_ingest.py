"""Convert an RRTMGP NetCDF k-distribution to the engine's npz schema.

Usage:  python tools/rrtmgp_ingest.py rrtmgp-gas-lw-g256.nc out_lw.npz

The reference loads these files at runtime through the external RRTMGP
library (load_and_init, GEOS_SolarGridComp.F90:4609-4621); this tool
ingests the same files offline into the plain-array schema consumed by
geosradiation_gridcomp.models.rrtmgp.gas_optics (schema documented
there). RRTMGP coefficient files are NetCDF4/HDF5; h5py reads them
directly (no netCDF4 dependency).

Axis conventions in the source files (rrtmgp data repo):
  kmajor [temp, eta, press+1, gpt]; some releases (and the same file
  family read through tools that preserve the Fortran axis order)
  store the REVERSED layout [gpt, press+1, eta, temp]. Both are
  detected from the unambiguous axis sizes (ntemp from temp_ref,
  npress+1 from press_ref, ngpt from bnd_limits_gpt) and normalized
  to the engine schema; same for kminor_lower/upper
  [temp, eta, contributor-gpt], plank_fraction (like kmajor),
  rayl_lower/upper [temp, eta, gpt], vmr_ref, flavor and
  gpoint_flavor. totplnk [temp_planck, band].
Gas-name variables appear either as string arrays or as NetCDF
char arrays [n, strlen]; both decode through _str.
"""

import sys

import numpy as np


def _normalize(a, want, name):
    """Return `a` transposed so its shape matches the size-pattern
    `want` (a tuple of ints, None = any size). The only layouts seen in
    the wild are the schema order and its full reverse (C-order vs
    preserved Fortran order), so that is what is detected; ambiguous
    matches (both orders fit) are rejected rather than guessed."""
    def fits(shape):
        return len(shape) == len(want) and all(
            w is None or s == w for s, w in zip(shape, want))

    fwd, rev = fits(a.shape), fits(a.shape[::-1])
    if fwd and rev and a.ndim > 1 and a.shape != a.shape[::-1]:
        raise ValueError(
            f"{name}: shape {a.shape} matches {want} both ways")
    if fwd:
        return a
    if rev:
        return a.transpose(range(a.ndim - 1, -1, -1))
    raise ValueError(f"{name}: shape {a.shape} does not match {want} "
                     "in either axis order")


def _read_nc(path):
    import h5py
    f = h5py.File(path, "r")
    return {k: np.asarray(v) for k, v in f.items()}


def _str(a):
    """Decode a NetCDF char-array [n, strlen] to a list of str."""
    if a.dtype.kind in "SU":
        if a.ndim == 2:
            return ["".join(c.decode() if isinstance(c, bytes) else c
                            for c in row).strip() for row in a]
        return [s.decode().strip() if isinstance(s, bytes)
                else str(s).strip() for s in a]
    raise ValueError(a.dtype)


def _minor_block(nc, which, ntemp):
    """Assemble one atmosphere-half's minor-contributor block."""
    km = nc.get(f"kminor_{which}")
    if km is None or km.size == 0:
        return None
    gas_names = _str(nc["gas_names"])
    minor_gases = _str(nc[f"minor_gases_{which}"])
    scaling_gas = _str(nc[f"scaling_gas_{which}"])
    gidx = np.array([gas_names.index(g) + 1 for g in minor_gases],
                    np.int64)
    sidx = np.array([0 if not g else gas_names.index(g) + 1
                     for g in scaling_gas], np.int64)
    lims = _normalize(
        np.asarray(nc[f"minor_limits_gpt_{which}"], np.int64),
        (len(minor_gases), 2), f"minor_limits_gpt_{which}")
    nk_total = int((lims[:, 1] - lims[:, 0] + 1).sum())
    km = _normalize(np.asarray(km, np.float32),
                    (ntemp, None, nk_total), f"kminor_{which}")
    if km.shape[2] != nk_total:
        raise ValueError(
            f"kminor_{which} contributor axis {km.shape[2]} != "
            f"sum of gpt ranges {nk_total}")
    return dict(
        kminor=km,
        gpt_limits=lims,
        gas_idx=gidx,
        scales_with_density=np.asarray(
            nc[f"minor_scales_with_density_{which}"], bool),
        scaling_gas=sidx,
        scale_by_complement=np.asarray(
            nc[f"scale_by_complement_{which}"], bool),
    )


def convert(path_in, path_out):
    nc = _read_nc(path_in)
    gas_names = _str(nc["gas_names"])
    ngas = len(gas_names)
    press_ref = np.asarray(nc["press_ref"], np.float64)
    temp_ref = np.asarray(nc["temp_ref"], np.float64)
    ntemp, npp = temp_ref.size, press_ref.size + 1
    band_lims_gpt = _normalize(
        np.asarray(nc["bnd_limits_gpt"], np.int64),
        (None, 2), "bnd_limits_gpt")
    ngpt = int(band_lims_gpt.max())
    out = dict(
        gas_names=np.array(gas_names),
        h2o_idx=np.int64(gas_names.index("h2o") + 1),
        press_ref=press_ref,
        press_ref_trop=np.float64(nc["press_ref_trop"]),
        temp_ref=temp_ref,
        vmr_ref=_normalize(np.asarray(nc["vmr_ref"], np.float64),
                           (2, ngas + 1, ntemp), "vmr_ref"),
        flavor=_normalize(np.asarray(nc["flavor"], np.int64).T,
                          (None, 2), "flavor"),
        gpoint_flavor=_normalize(
            np.asarray(nc["gpoint_flavor"], np.int64),
            (2, ngpt), "gpoint_flavor"),
        kmajor=_normalize(np.asarray(nc["kmajor"], np.float32),
                          (ntemp, None, npp, ngpt), "kmajor"),
        band_lims_gpt=band_lims_gpt,
        band_lims_wvn=_normalize(
            np.asarray(nc["bnd_limits_wavenumber"], np.float64),
            (band_lims_gpt.shape[0], 2), "bnd_limits_wavenumber"),
    )
    for which in ("lower", "upper"):
        blk = _minor_block(nc, which, ntemp)
        if blk:
            for k, v in blk.items():
                out[f"minor_{which}_{k}"] = v
    if "totplnk" in nc:
        nbnd = band_lims_gpt.shape[0]
        out["totplnk"] = _normalize(
            np.asarray(nc["totplnk"], np.float64),
            (None, nbnd), "totplnk")
        out["planck_frac"] = _normalize(
            np.asarray(nc["plank_fraction"], np.float32),
            (ntemp, None, npp, ngpt), "plank_fraction")
        out["temp_ref_planck"] = np.asarray(
            nc.get("temperature_Planck",
                   np.arange(160.0, 160.0 + out["totplnk"].shape[0])),
            np.float64)
    if "solar_source_quiet" in nc or "solar_source" in nc:
        q = nc.get("solar_source", nc.get("solar_source_quiet"))
        out["solar_src"] = np.asarray(q, np.float64)
        out["rayl"] = np.stack(
            [_normalize(np.asarray(nc[f"rayl_{w}"], np.float32),
                        (ntemp, None, ngpt), f"rayl_{w}")
             for w in ("lower", "upper")])
    np.savez_compressed(path_out, **out)
    print(f"wrote {path_out}: "
          f"{out['kmajor'].shape[-1]} g-points, "
          f"{out['band_lims_gpt'].shape[0]} bands, "
          f"{len(gas_names)} gases")


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2])
