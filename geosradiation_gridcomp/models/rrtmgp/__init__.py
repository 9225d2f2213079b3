"""RRTMGP-style radiation scheme (the reference's third scheme).

The reference treats RRTMGP as an EXTERNAL library: this repo contributes
only the build assembly (GEOS_RadiationShared/RRTMGP_cmake), the RNG class
hierarchy (RRTMGP_cmake/rng/*), and the driver plumbing in the Solar/Irrad
GCs (gas_concs setup, load_and_init, set_solar_variability, cloud
sampling via mo_cloud_sampling, then rte_sw/rte_lw). This package
provides JAX equivalents of that entire surface:

  * GasConcs             - mo_gas_concentrations equivalent
  * KDistSW / KDistLW    - ty_gas_optics_rrtmgp facade; the default
                           backend is the RRTMG-reduced k-distribution
                           shipped with this package (g112 SW / g140 LW),
                           driven through the same generic interface the
                           GC uses (get_ngpt, set_solar_variability,
                           gas_optics, ...)
  * rng                  - mo_rng equivalents (threefry/MT19937)
  * sampling             - mo_cloud_sampling equivalents
                           (sampled_mask_max_ran, sampled_urand_gen_max_ran,
                           draw_samples)
  * rte                  - generic rte_sw (two-stream+adding) and rte_lw
                           (no-scattering diffusivity) solvers over
                           (tau, ssa, g) optical props
"""

from .gas_concs import GasConcs                              # noqa: F401
from .kdist import KDistSW, KDistLW                          # noqa: F401
from .sampling import (sampled_mask_max_ran,                 # noqa: F401
                       sampled_urand_gen_max_ran, draw_samples)
from .rte import rte_sw, rte_lw                              # noqa: F401
from .scheme import rrtmgp_sw, rrtmgp_lw                     # noqa: F401
