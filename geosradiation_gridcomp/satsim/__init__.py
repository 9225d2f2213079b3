"""Satellite-simulator subsystem (the reference's GEOSsatsim_GridComp /
COSP v1.x stack, SURVEY.md par. 2.7), re-designed for batched JAX: all simulators
are pure vectorized functions over (points, subcolumns, levels) batches,
level sweeps are lax.scans / cumulative ops, and the subcolumn sampler
uses counter-based jax.random instead of the congruential RNG (population
statistics are the contract, as for McICA)."""

from .scops import scops, prec_scops                        # noqa: F401
from .icarus import isccp_simulator                         # noqa: F401
from .misr import misr_simulator                            # noqa: F401
from .modis import modis_l2_simulator, modis_l3_simulator   # noqa: F401
from .lidar import lidar_simulator, lidar_stats, parasol    # noqa: F401
from .radar import (quickbeam_simulator, radar_cfad,        # noqa: F401
                    lidar_only_freq_cloud)
from .cosp import cosp_simulator, SatsimInputs, SatsimConfig  # noqa: F401
