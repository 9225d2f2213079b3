"""Atmospheric radiation framework in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of NASA's GEOS
radiation component (GEOS-ESM/GEOSradiation_GridComp): shortwave and longwave
broadband fluxes and heating rates with interchangeable correlated-k schemes
(Chou-Suarez sorad/irrad, RRTMG SW/LW), McICA stochastic cloud subcolumns,
cloud/aerosol optics, and intermittent-refresh driver semantics.

Design: columns are the batched/vectorized axis (sharded over a device mesh),
g-points/bands are fused spectral axes, and vertical sweeps are on-device
scans. All numerical tables are extracted from the reference Fortran
into npz artifacts (tools/extract_fortran_data.py); no code is ported.
"""

__version__ = "0.1.0"
