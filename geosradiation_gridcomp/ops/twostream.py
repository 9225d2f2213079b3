"""Delta-Eddington two-stream layer optics (the reference's `deledd`).

Re-derivation of sorad.F90:1592-1706 (King & Harshvardhan 1986 closed form),
fully vectorized: one call computes R/T/Td for arbitrarily-shaped batches of
(tau, ssa, g, mu0). The reference promotes to float64 to survive the removable
singularity at akk*mu0 -> 1; here we keep float32 and widen the
zenith-angle nudge window accordingly (the nudge idea is the reference's own,
sorad.F90:1661-1668).
"""

import jax.numpy as jnp


def deledd(tau, ssc, g0, zth, thresh=1e-3):
    """Delta-Eddington reflection/transmission of a homogeneous layer.

    Args:
      tau: optical thickness
      ssc: single-scattering albedo (< 1)
      g0: asymmetry factor
      zth: cosine of incidence angle
      All broadcastable to a common shape.

    Returns:
      (rr, tt, td): reflection of the direct beam, total (direct+diffuse)
      transmission, direct transmission.
    """
    ff = g0 * g0
    xx = 1.0 - ff * ssc
    taup = tau * xx
    sscp = ssc * (1.0 - ff) / xx
    gp = g0 / (1.0 + g0)

    x3 = 3.0 * gp
    gm1 = (7.0 - sscp * (4.0 + x3)) * 0.25
    gm2 = -(1.0 - sscp * (4.0 - x3)) * 0.25

    akk = jnp.sqrt(jnp.maximum((gm1 + gm2) * (gm1 - gm2), 1e-30))

    # nudge zth away from the akk*zth == 1 resonance (removable singularity)
    st3_test = 1.0 - (akk * zth) ** 2
    zth_n = jnp.where(jnp.abs(st3_test) < thresh,
                      jnp.where(zth + 0.001 > 1.0, zth - 0.001, zth + 0.001),
                      zth)
    xx = akk * zth_n
    st7 = 1.0 - xx
    st8 = 1.0 + xx
    st3 = st7 * st8

    td = jnp.exp(-taup / zth_n)

    gm3 = (2.0 - zth_n * 3.0 * gp) * 0.25
    xx = gm1 - gm2
    alf1 = gm1 - gm3 * xx
    alf2 = gm2 + gm3 * xx

    xx = akk * 2.0
    all_ = (gm3 - alf2 * zth_n) * xx * td
    bll = (1.0 - gm3 + alf1 * zth_n) * xx

    xx = akk * gm3
    cll = (alf2 + xx) * st7
    dll = (alf2 - xx) * st8

    xx = akk * (1.0 - gm3)
    fll = (alf1 + xx) * st8
    ell = (alf1 - xx) * st7

    st2 = jnp.exp(-akk * taup)
    st4 = st2 * st2

    st1 = sscp / ((akk + gm1 + (akk - gm1) * st4) * st3)

    rr = jnp.maximum((cll - dll * st4 - all_ * st2) * st1, 0.0)
    tt = jnp.maximum(-((fll - ell * st4) * td - bll * st2) * st1, 0.0)
    tt = tt + td
    return rr, tt, td
