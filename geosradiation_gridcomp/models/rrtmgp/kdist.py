"""k-distribution gas optics facade (ty_gas_optics_rrtmgp equivalent).

The reference loads the external RRTMGP library's k-distribution from
NetCDF (load_and_init of 'rrtmgp-gas-sw-g112.nc' / RRTMGP_GAS_LW,
GEOS_SolarGridComp.F90:4609-4621, GEOS_IrradGridComp.F90:2151+) and
calls it through a generic interface. This module provides that
interface in JAX. The default backend is the RRTMG-reduced
k-distribution shipped with this package (14 band/112 gpt SW, 16
band/140 gpt LW), driven through the same generic calls the GC makes:
get_ngpt/get_nband/band limits, set_solar_variability(Mg, SB),
gas_optics(...). A loader for native RRTMGP NetCDF coefficient files
can plug in as an alternative backend behind the same facade (the
eta-interpolation kernel is engine work scheduled for a later round;
the reference itself vendors none of it).
"""

import numpy as np

import jax.numpy as jnp

from ..rrtmg import nrlssi2
from ..rrtmg.setcoef_lw import setcoef_lw
from ..rrtmg.setcoef_sw import setcoef_sw
from ..rrtmg.taumol_lw import taumol_lw
from ..rrtmg.taumol_sw import taumol_sw
from ..rrtmg.tables_lw import NG_LW
from ..rrtmg.tables_sw import NG_SW
from .gas_concs import GasConcs

# band limits [cm^-1]
_SW_WAVENUM1 = np.array([2600., 3250., 4000., 4650., 5150., 6150., 7700.,
                         8050., 12850., 16000., 22650., 29000., 38000.,
                         820.])
_SW_WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                         12850., 16000., 22650., 29000., 38000., 50000.,
                         2600.])
_LW_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                         1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                         2600.])
_LW_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080.,
                         1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                         2600., 3250.])


def _band_lims_gpt(ng_per_band):
    ends = np.cumsum(ng_per_band)
    starts = ends - np.asarray(ng_per_band) + 1
    return np.stack([starts, ends], axis=-1)      # 1-based inclusive


class KDistSW:
    """SW gas optics with an external (solar) source."""

    def __init__(self):
        self._svw = None        # solar variability weights

    # --- metadata surface used by the driver layer -----------------
    def source_is_external(self):
        return True

    def get_ngpt(self):
        return int(np.sum(NG_SW))

    def get_nband(self):
        return len(NG_SW)

    def get_band_lims_wavenumber(self):
        return np.stack([_SW_WAVENUM1, _SW_WAVENUM2], axis=-1)

    def get_band_lims_gpoint(self):
        return _band_lims_gpt(NG_SW)

    def get_press_min(self):
        return 1.0              # Pa; backend tables top out near 0.01 hPa

    def get_temp_min(self):
        return 160.0

    def set_solar_variability(self, mg, sb):
        """NRLSSI2 facular/sunspot adjustment (k_dist%set_solar_variability,
        GEOS_SolarGridComp.F90:4629): isolvar=2 semantics with the indices
        taken from the solar-cycle file."""
        self._svw = nrlssi2.solar_source_weights(
            2, 0.0, indsolvar=(float(mg), float(sb)))
        return self

    # --- compute ----------------------------------------------------
    def gas_optics(self, play_hpa, tlay, plev_hpa, gas_concs: GasConcs):
        """Gas optical depths, Rayleigh optical depths, and the solar
        source per g-point.

        play/tlay: [ncol, nlay] (TOA-first, hPa/K); plev: [ncol, nlay+1].
        Returns (taug, taur, toa_src) with taug/taur [ncol, nlay, ngpt]
        and toa_src [ncol, ngpt] (unnormalized; scale by tsi/mu0 in rte).
        """
        g = gas_concs
        h2o = g.get_vmr("h2o", like=tlay)
        coefs = setcoef_sw(play_hpa, tlay, plev_hpa, h2o,
                           g.get_vmr("o3", like=tlay),
                           g.get_vmr("co2", like=tlay),
                           g.get_vmr("ch4", like=tlay),
                           g.get_vmr("o2", like=tlay))
        taug, taur, sflux = taumol_sw(coefs, self._svw)
        return taug, taur, sflux


def load_kdist_npz(path):
    """Load a native k-distribution (tools/rrtmgp_ingest.py schema) into
    the dict form the engine consumes, reassembling the minor blocks."""
    raw = dict(np.load(path, allow_pickle=False))
    data = {k: v for k, v in raw.items() if not k.startswith("minor_")}
    for which in ("lower", "upper"):
        pre = f"minor_{which}_"
        keys = [k for k in raw if k.startswith(pre)]
        data[f"minor_{which}"] = (
            {k[len(pre):]: raw[k] for k in keys} if keys else None)
    if "h2o_idx" not in data:
        names = [str(s) for s in data["gas_names"]]
        data["h2o_idx"] = np.int64(names.index("h2o") + 1)
    return data


class KDistLWNative:
    """LW gas optics backed by the NATIVE interpolation engine
    (gas_optics.py) driven by an ingested RRTMGP coefficient set -
    the genuine ty_gas_optics_rrtmgp capability: arbitrary bands,
    g-points, gases, flavors, and minor contributors.

    Pair with rte_native.rte_lw_native for arbitrary band structures
    (the shipped rte.rte_lw assumes the 16-band RRTMG layout).
    """

    def __init__(self, data):
        if isinstance(data, (str, bytes)):
            data = load_kdist_npz(data)
        self.data = data

    def source_is_external(self):
        return False

    def get_ngpt(self):
        return int(self.data["kmajor"].shape[-1])

    def get_nband(self):
        return int(self.data["band_lims_gpt"].shape[0])

    def get_band_lims_wavenumber(self):
        return np.asarray(self.data["band_lims_wvn"])

    def get_band_lims_gpoint(self):
        return np.asarray(self.data["band_lims_gpt"])

    def get_press_min(self):
        return float(np.min(self.data["press_ref"]))

    def get_temp_min(self):
        return float(np.min(self.data["temp_ref"]))

    def gas_optics(self, play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
                   gas_concs: GasConcs, dudts=False):
        from .gas_optics import gas_optics_lw
        del emis, dudts                 # dplankbnd_dts always computed
        names = [str(s) for s in self.data["gas_names"]]
        vmrs = {nm: gas_concs.get_vmr(nm, like=tlay) for nm in names}
        return gas_optics_lw(self.data, play_hpa * 100.0, tlay,
                             plev_hpa * 100.0, tlev, tsfc, vmrs)


class KDistSWNative:
    """SW counterpart of KDistLWNative (external solar source)."""

    def __init__(self, data):
        if isinstance(data, (str, bytes)):
            data = load_kdist_npz(data)
        self.data = data

    def source_is_external(self):
        return True

    def get_ngpt(self):
        return int(self.data["kmajor"].shape[-1])

    def get_nband(self):
        return int(self.data["band_lims_gpt"].shape[0])

    def get_band_lims_wavenumber(self):
        return np.asarray(self.data["band_lims_wvn"])

    def get_band_lims_gpoint(self):
        return np.asarray(self.data["band_lims_gpt"])

    def set_solar_variability(self, mg, sb):
        # native files carry quiet/facular/sunspot components; the
        # shipped synthetic sets carry only the quiet sun
        return self

    def gas_optics(self, play_hpa, tlay, plev_hpa, gas_concs: GasConcs):
        from .gas_optics import gas_optics_sw
        names = [str(s) for s in self.data["gas_names"]]
        vmrs = {nm: gas_concs.get_vmr(nm, like=tlay) for nm in names}
        return gas_optics_sw(self.data, play_hpa * 100.0, tlay,
                             plev_hpa * 100.0, vmrs)


class KDistLW:
    """LW gas optics with an internal (Planck) source."""

    def source_is_external(self):
        return False

    def get_ngpt(self):
        return int(np.sum(NG_LW))

    def get_nband(self):
        return len(NG_LW)

    def get_band_lims_wavenumber(self):
        return np.stack([_LW_WAVENUM1, _LW_WAVENUM2], axis=-1)

    def get_band_lims_gpoint(self):
        return _band_lims_gpt(NG_LW)

    def get_press_min(self):
        return 1.0

    def get_temp_min(self):
        return 160.0

    def gas_optics(self, play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
                   gas_concs: GasConcs, dudts=False):
        """Gas optical depths and Planck sources per g-point.

        Returns (taug, sources) where sources is a dict with pfracs,
        planklay, planklev, plankbnd, dplankbnd_dts, pwvcm - the inputs
        of rte.rte_lw.
        """
        g = gas_concs
        coefs = setcoef_lw(
            play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
            g.get_vmr("h2o", like=tlay), g.get_vmr("o3", like=tlay),
            g.get_vmr("co2", like=tlay), g.get_vmr("ch4", like=tlay),
            g.get_vmr("n2o", like=tlay), g.get_vmr("o2", like=tlay),
            g.get_vmr("co", like=tlay), g.get_vmr("cfc11", like=tlay),
            g.get_vmr("cfc12", like=tlay),
            g.get_vmr("hcfc22", like=tlay),
            g.get_vmr("ccl4", like=tlay), dudts=dudts)
        taug, pfracs = taumol_lw(coefs, None)
        sources = dict(pfracs=pfracs, planklay=coefs.planklay,
                       planklev=coefs.planklev, plankbnd=coefs.plankbnd,
                       dplankbnd_dts=coefs.dplankbnd_dts,
                       pwvcm=coefs.pwvcm)
        return taug, sources
