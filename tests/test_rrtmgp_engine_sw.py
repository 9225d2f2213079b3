"""Native-kdist SW end-to-end: gas_optics_sw -> rte_sw_native."""

import jax.numpy as jnp
import numpy as np

from geosradiation_gridcomp.models.rrtmgp.kdist import KDistSWNative
from geosradiation_gridcomp.models.rrtmgp.gas_concs import GasConcs
from geosradiation_gridcomp.models.rrtmgp.rte_native import (
    rte_sw_native)

from test_rrtmgp_engine import make_kdist, make_atmos, NGPT, NBND


def test_native_sw_end_to_end_conservation():
    """Transparent gases + Rayleigh only: TOA down = sum(src)*mu0; with
    albedo 1 and pure scattering, reflection approaches incidence; net
    column absorption is non-negative and bounded."""
    data = make_kdist(constant_k=0.0)
    data["minor_lower"] = None
    kd = KDistSWNative(data)
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos()
    gas = GasConcs()
    for nm, v in vmrs.items():
        gas.set_vmr(nm, v)
    taug, taur, src = kd.gas_optics(play * 0.01, tlay, plev * 0.01, gas)
    assert float(jnp.max(taug)) == 0.0
    ncol = tlay.shape[0]
    mu0 = jnp.asarray(np.linspace(0.3, 0.9, ncol), jnp.float32)
    alb = jnp.ones((ncol, NBND), jnp.float32)
    out = rte_sw_native(taug, taur, src, mu0, alb, alb,
                        kd.get_band_lims_gpoint())
    toa_dn = np.asarray(out["flux_dn"])[:, 0]
    want = NGPT * 85.0 * np.asarray(mu0)
    assert np.abs(toa_dn - want).max() < 1e-3 * want.max()
    # pure scattering + perfect reflector: nothing is absorbed, so the
    # TOA upward flux must return the full incidence
    toa_up = np.asarray(out["flux_up"])[:, 0]
    assert np.abs(toa_up - want).max() < 2e-3 * want.max()
    # band split of the surface down-flux sums to the total
    bs = np.asarray(out["band_dn_sfc"]).sum(axis=1)
    sfc = np.asarray(out["flux_dn"])[:, -1]
    assert np.abs(bs - sfc).max() < 1e-3 * np.abs(sfc).max()