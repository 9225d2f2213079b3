"""SCOPS: Subgrid Cloud Overlap Profile Sampler (+ precip assignment).

Re-derivations of the reference's scops.f:40+ and llnl/prec_scops.f in
JAX: the level loop carrying the overlap threshold becomes a lax.scan
with all (point, subcolumn) lanes vectorized; the Marsaglia congruential
RNG (congvec.f) is replaced by counter-based jax.random draws - the
population statistics (per-level cloud cover, overlap structure) are the
contract, not the bit sequence.

Subcolumn codes match the reference: frac_out 0 = clear, 1 = stratiform
cloud, 2 = convective cloud; prec_frac 0 = clear, 1 = large-scale precip,
2 = convective precip, 3 = both. All arrays TOA-first.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("nsubcol", "overlap"))
def scops(key, cc, conv, nsubcol, overlap=3):
    """Sample binary cloud subcolumns from layer cloud fractions.

    Args:
      key: jax PRNG key.
      cc:   [npoints, nlev] TOTAL cloud fraction per layer (TOA-first).
      conv: [npoints, nlev] convective cloud fraction per layer.
      nsubcol: number of subcolumns (static).
      overlap: 1 max, 2 random, 3 max-random (scops.f:49-52).

    Returns frac_out [npoints, nsubcol, nlev] int8 (0/1/2).
    """
    npoints, nlev = cc.shape
    dtype = cc.dtype
    # ordered pointer to position in gridbox (scops.f:104-108)
    boxpos = ((jnp.arange(nsubcol, dtype=dtype) + 0.5) / nsubcol)[None, :]

    ran = jax.random.uniform(key, (nlev, npoints, nsubcol), dtype)

    # initial threshold (scops.f:168-186): evenly spread for max overlap,
    # else random within the non-convective part. Only consulted by the
    # max-random maxosc test at the first level, where tca_prev=0 makes
    # it moot; kept for fidelity.
    if overlap == 1:
        thresh0 = jnp.broadcast_to(boxpos, (npoints, nsubcol))
    else:
        c0 = conv[:, 0][:, None]
        thresh0 = c0 + (1.0 - c0) * ran[0]

    def step(carry, xs):
        thresh, tca_prev = carry
        cc_l, conv_l, ran_l = xs
        ccx = cc_l[:, None]
        cvx = conv_l[:, None]
        # max-overlapped convective part (scops.f:205-211)
        maxocc = boxpos <= cvx
        if overlap == 1:
            tmin = cvx
            maxosc = jnp.ones_like(maxocc)
        elif overlap == 2:
            tmin = cvx
            maxosc = jnp.zeros_like(maxocc)
        else:
            mintca = jnp.minimum(tca_prev, cc_l)[:, None]
            tmin = jnp.maximum(cvx, mintca)
            maxosc = (thresh < mintca) & (thresh > cvx)
        # threshold reset (scops.f:249-272)
        thresh = jnp.where(
            maxocc, jnp.broadcast_to(boxpos, thresh.shape),
            jnp.where(maxosc, thresh, tmin + (1.0 - tmin) * ran_l))
        # fill: 1 where tca exceeds threshold, 2 in the convective part
        frac = jnp.where(ccx > thresh, jnp.int8(1), jnp.int8(0))
        frac = jnp.where(thresh <= cvx, jnp.int8(2), frac)
        return (thresh, cc_l), frac

    (_, _), frac_seq = lax.scan(
        step, (thresh0, jnp.zeros((npoints,), dtype)),
        (cc.T, conv.T, ran))
    return jnp.moveaxis(frac_seq, 0, -1)     # [npoints, nsubcol, nlev]


@jax.jit
def prec_scops(ls_p_rate, cv_p_rate, frac_out):
    """Assign precipitation occurrence to subcolumns (llnl/prec_scops.f).

    Fallback cascade per level and precip type: (1) subcolumns cloudy at
    this level or precipitating just above; (2) cloudy at the level below;
    (3) cloudy anywhere in the column; (4) all subcolumns (LS) / the first
    5% of subcolumns (convective).

    Args: ls/cv_p_rate [npoints, nlev] precip rates; frac_out
    [npoints, nsubcol, nlev] from scops. Returns prec_frac int8 (0/1/2/3).
    """
    npoints, nsubcol, nlev = frac_out.shape
    cv_col = max(int(0.05 * nsubcol), 1)
    first_cv = (jnp.arange(nsubcol) < cv_col)[None, :]

    cld_ls = frac_out == 1               # [np, nsub, nlev]
    cld_cv = frac_out == 2
    anyls_col = cld_ls.any(axis=-1)      # [np, nsub] cloudy anywhere
    anycv_col = cld_cv.any(axis=-1)
    # level-below occupancy (possibility THREE); zero pad at the bottom
    pad = jnp.zeros((npoints, nsubcol, 1), bool)
    below_ls = jnp.concatenate([cld_ls[..., 1:], pad], axis=-1)
    below_cv = jnp.concatenate([cld_cv[..., 1:], pad], axis=-1)

    def pick(now, below, anywhere, everyone):
        """First non-empty candidate set per (point, level-step)."""
        f1 = now.any(axis=-1, keepdims=True)
        f2 = below.any(axis=-1, keepdims=True)
        f3 = anywhere.any(axis=-1, keepdims=True)
        return jnp.where(f1, now,
                         jnp.where(f2, below,
                                   jnp.where(f3, anywhere, everyone)))

    all_cols = jnp.ones((npoints, nsubcol), bool)

    def step(carry, xs):
        prev = carry                      # prec_frac at the level above
        lsr, cvr, now_ls, now_cv, bel_ls, bel_cv = xs
        from_above_ls = (prev == 1) | (prev == 3)
        from_above_cv = (prev == 2) | (prev == 3)
        ls = pick(now_ls | from_above_ls, bel_ls, anyls_col, all_cols)
        cv = pick(now_cv | from_above_cv, bel_cv, anycv_col, first_cv)
        ls = ls & (lsr > 0.0)[:, None]
        cv = cv & (cvr > 0.0)[:, None]
        pf = (jnp.where(ls, 1, 0) + jnp.where(cv, 2, 0)).astype(jnp.int8)
        return pf, pf

    xs = (ls_p_rate.T, cv_p_rate.T,
          jnp.moveaxis(cld_ls, -1, 0), jnp.moveaxis(cld_cv, -1, 0),
          jnp.moveaxis(below_ls, -1, 0), jnp.moveaxis(below_cv, -1, 0))
    _, pf_seq = lax.scan(step, jnp.zeros((npoints, nsubcol), jnp.int8), xs)
    return jnp.moveaxis(pf_seq, 0, -1)
