"""RRTMG-LW rtrnmc sweeps as one Pallas kernel for NVIDIA GPUs (Triton).

The jnp rtrnmc (rtrnmc.py) materialises about ten float32
[ncol, nlay, ngpt] arrays around its two lax.scans: the scan inputs and
the radiance stacks that are read back only for the delwave sums. This
kernel reads taug, pfracs and taucmc once per sweep plus the band Planck
terms, keeps the carried radiances in registers, and writes only the
[ncol, nlay+1] fluxes and the TOA radiances (for the band OLR).

Layout: one program per block of BLOCK_COLS columns; the g-points of a
column are held as power-of-two lane chunks (140 = 128 + a masked 16);
both layer loops run inside the kernel, and the per-level sum over g is
taken in the kernel, so no reduction crosses programs. On a column mesh
the kernel is partitioned along the column axis (custom_partitioning),
so each device runs it on its own columns and it adds no collective.

rtrnmc_for_platform is the refresh's choice of implementation: on a
CUDA device the kernel, on the CPU the jnp reference, and any other
platform fails when the step is lowered.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec as P

from .rtrnmc import _DELWAVE_G, _NGB, diffusivity_secant, rtrnmc

KERNEL_NAME = "rtrnmc_sweeps"
# columns and warps per program: timed on an H100 at 8192 columns x 72
# and 181 levels (1.6 / 3.6 ms), as fast as any of 2-16 columns with
# 2-8 warps (2 columns on 2 warps was within 2%)
BLOCK_COLS = 4
NUM_WARPS = 4


def _lane_chunks(n):
    """(start, width) power-of-two lane chunks covering n g-points: the
    largest power of two that fits, then one masked chunk for the rest."""
    head = 1 << (n.bit_length() - 1)
    rest = n - head
    if rest == 0:
        return ((0, head),)
    return ((0, head), (head, max(16, 1 << (rest - 1).bit_length())))


def _tfn(tau, tr):
    """rtrnmc._tfn with the transmittance exp(-tau) passed in."""
    safe_tau = jnp.maximum(tau, 1e-9)
    direct = 1.0 - 2.0 * (1.0 / safe_tau - tr / jnp.maximum(1.0 - tr, 1e-12))
    return jnp.where(tau < 0.06, tau / 6.0, direct)


def _sweep_kernel(taug_ref, pfr_ref, tcm_ref, cldy_ref, blay_ref, blev_ref,
                  semiss_ref, pbnd_ref, dpbnd_ref, secd_ref, ngb_ref, dw_ref,
                  uflx_ref, dflx_ref, uflxc_ref, dflxc_ref, *rest,
                  block_cols, chunks, dudts):
    if dudts:
        du_ref, duc_ref, toa_ref, dtoa_ref = rest
    else:
        (toa_ref,) = rest
    ncol, nlay, ngpt = taug_ref.shape
    c = pl.program_id(0) * block_cols + jnp.arange(block_cols)
    cm = c < ncol
    cc = c[:, None]
    lanes = []                  # per chunk: (g, mask, band index, delwave)
    for start, width in chunks:
        g = start + jnp.arange(width)
        gm = g < ngpt
        ngb = plgpu.load(ngb_ref.at[g], mask=gm, other=0)[None, :]
        dw = plgpu.load(dw_ref.at[g], mask=gm, other=0.0)[None, :]
        lanes.append((g[None, :], cm[:, None] & gm[None, :], ngb, dw))

    def band(ref, lev, ln):
        _, m, ngb, _ = ln
        if lev is None:
            return plgpu.load(ref.at[cc, ngb], mask=m, other=0.0)
        return plgpu.load(ref.at[cc, lev, ngb], mask=m, other=0.0)

    def gpt(ref, k, ln):
        g, m, _, _ = ln
        return plgpu.load(ref.at[cc, k, g], mask=m, other=0.0)

    def flux(rads):
        return sum(jnp.sum(r * ln[3], axis=1) for r, ln in zip(rads, lanes))

    def put(ref, lev, rads):
        plgpu.store(ref.at[c, lev], flux(rads), mask=cm)

    secd = [plgpu.load(secd_ref.at[cc, ln[2]], mask=ln[1], other=1.66)
            for ln in lanes]

    def optics(k, lev, ln, sec):
        # effective absorptivity and Planck source of layer k, with the
        # linear-in-tau source towards level `lev` (rtrnmc.F90:196-254)
        tg, pf, tc = (gpt(r, k, ln) for r in (taug_ref, pfr_ref, tcm_ref))
        blay = band(blay_ref, k, ln)
        dpl = band(blev_ref, lev, ln) - blay
        odepth = jnp.maximum(sec * tg, 0.0)
        odtot = odepth + sec * tc
        trg = jnp.exp(-odepth)
        trt = jnp.exp(-odtot)
        agas = 1.0 - trg
        bbgas = pf * (blay + _tfn(odepth, trg) * dpl)
        bbtot = pf * (blay + _tfn(odtot, trt) * dpl)
        cld = tc > 0.0
        return (jnp.where(cld, 1.0 - trt, agas), jnp.where(cld, bbtot, bbgas),
                agas, bbgas)

    # ---- downward sweep (TOA -> surface) ----
    dt = taug_ref.dtype
    zero = [jnp.zeros((block_cols, w), dt) for _, w in chunks]
    plgpu.store(dflx_ref.at[c, 0], jnp.zeros((block_cols,), dt), mask=cm)
    plgpu.store(dflxc_ref.at[c, 0], jnp.zeros((block_cols,), dt), mask=cm)

    def down(k, carry):
        radld, radclr, div = carry
        div = jnp.maximum(div, plgpu.load(cldy_ref.at[c, k], mask=cm,
                                          other=0.0))
        diverged = div[:, None] > 0.0
        new_ld, new_clr = [], []
        for ln, sec, rl, rc in zip(lanes, secd, radld, radclr):
            a_eff, bb_eff, agas, bbgas = optics(k, k + 1, ln, sec)
            rl = rl + (bb_eff - rl) * a_eff
            rc = jnp.where(diverged, rc + (bbgas - rc) * agas, rl)
            new_ld.append(rl)
            new_clr.append(rc)
        put(dflx_ref, k + 1, new_ld)
        put(dflxc_ref, k + 1, new_clr)
        return new_ld, new_clr, div

    radld, radclr, div = lax.fori_loop(
        0, nlay, down, (zero, zero, jnp.zeros((block_cols,), dt)))

    # ---- surface emission and reflection (rtrnmc.F90:344-352) ----
    radlu, radclru, dlu = [], [], []
    for ln, rl, rc in zip(lanes, radld, radclr):
        pf_sfc = gpt(pfr_ref, nlay - 1, ln)
        rad0 = pf_sfc * band(pbnd_ref, None, ln)
        reflect = 1.0 - band(semiss_ref, None, ln)
        radlu.append(rad0 + reflect * rl)
        radclru.append(rad0 + reflect * rc)
        dlu.append(pf_sfc * band(dpbnd_ref, None, ln) if dudts
                   else jnp.zeros_like(rl))
    put(uflx_ref, nlay, radlu)
    put(uflxc_ref, nlay, radclru)
    if dudts:
        put(du_ref, nlay, dlu)
        put(duc_ref, nlay, dlu)

    # ---- upward sweep (surface -> TOA); the clear stream diverges from
    # the total wherever any layer of the column is cloudy ----
    divany = div[:, None] > 0.0

    def up(i, carry):
        k = nlay - 1 - i
        carry_out = ([], [], [], [])
        for ln, sec, rl, rc, d, dc in zip(lanes, secd, *carry):
            a_eff, bb_eff, agas, bbgas = optics(k, k, ln, sec)
            rl = rl + (bb_eff - rl) * a_eff
            rc = jnp.where(divany, rc + (bbgas - rc) * agas, rl)
            if dudts:
                d = d * (1.0 - a_eff)
                dc = jnp.where(divany, dc * (1.0 - agas), d)
            for lst, v in zip(carry_out, (rl, rc, d, dc)):
                lst.append(v)
        put(uflx_ref, k, carry_out[0])
        put(uflxc_ref, k, carry_out[1])
        if dudts:
            put(du_ref, k, carry_out[2])
            put(duc_ref, k, carry_out[3])
        return carry_out

    radlu, _, dlu, _ = lax.fori_loop(0, nlay, up,
                                     (radlu, radclru, dlu, list(dlu)))
    for ln, rl, d in zip(lanes, radlu, dlu):
        g, m, _, _ = ln
        plgpu.store(toa_ref.at[cc, g], rl, mask=m)
        if dudts:
            plgpu.store(dtoa_ref.at[cc, g], d, mask=m)


_OUT_KEYS = ("uflx", "dflx", "uflxc", "dflxc")
_DUDTS_KEYS = ("duflx_dts", "duflxc_dts")


def _sweeps(semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
            plankbnd, dplankbnd_dts, secd, ngb, dwg, *, dudts, interpret):
    """The pallas_call: level fluxes, then the TOA radiances per g."""
    ncol, nlay, ngpt = taug.shape
    lev = jax.ShapeDtypeStruct((ncol, nlay + 1), taug.dtype)
    toa = jax.ShapeDtypeStruct((ncol, ngpt), taug.dtype)
    out_shape = [lev] * (6 if dudts else 4) + [toa] * (2 if dudts else 1)
    kernel = partial(_sweep_kernel, block_cols=BLOCK_COLS,
                     chunks=_lane_chunks(ngpt), dudts=dudts)
    return tuple(pl.pallas_call(
        kernel,
        grid=(pl.cdiv(ncol, BLOCK_COLS),),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=KERNEL_NAME,
    )(taug, pfracs, taucmc, cloudy, planklay, planklev, semiss, plankbnd,
      dplankbnd_dts, secd, ngb, dwg))


def _leading_axis(sharding):
    spec = getattr(sharding, "spec", ())
    return spec[0] if len(spec) else None


@lru_cache(maxsize=None)
def _column_partitioned(**static):
    """_sweeps as one op that XLA partitions along the column axis: on a
    column mesh each device runs the kernel on its own columns, with no
    collective (a plain custom call would be gathered to every device)."""
    def fn(*args):
        return _sweeps(*args, **static)

    op = custom_partitioning(fn)

    def col(mesh, axis, x):
        return NamedSharding(mesh, P(axis, *(None,) * (len(x.shape) - 1)))

    def infer(mesh, arg_shapes, result_shape):
        axis = _leading_axis(arg_shapes[1].sharding)
        return tuple(col(mesh, axis, r) for r in result_shape)

    def partition(mesh, arg_shapes, result_shape):
        axis = _leading_axis(arg_shapes[1].sharding)
        return (mesh, fn, tuple(col(mesh, axis, r) for r in result_shape),
                tuple(col(mesh, axis if i < 10 else None, a)
                      for i, a in enumerate(arg_shapes)))

    # column factor c on the per-column operands and every result; the
    # g-point tables (n) are replicated and no other dimension is split
    ins = "c s, c l g, c l g, c l, c l g, c l b, c m b, c b, c b, c b, n, n"
    nout = (6 if static["dudts"] else 4)
    outs = ", ".join(["c m"] * nout + ["c g"] * (2 if static["dudts"]
                                                  else 1))
    op.def_partition(partition=partition,
                     infer_sharding_from_operands=infer,
                     sharding_rule=f"{ins} -> {outs}")
    return op


def rtrnmc_triton(semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
                  plankbnd, dplankbnd_dts, pwvcm, dudts=True, *,
                  interpret=False):
    """rtrnmc.rtrnmc as one Pallas kernel (same shapes and outputs).

    interpret runs the kernel in the Pallas interpreter, which is how it
    is tested on a CPU.
    """
    ncol = taug.shape[0]
    dt = taug.dtype
    dwg = jnp.asarray(_DELWAVE_G, dt)
    res = _column_partitioned(dudts=dudts, interpret=interpret)(
        semiss, taug, pfracs, cloudy.astype(dt), taucmc, planklay,
        planklev, plankbnd, dplankbnd_dts,
        diffusivity_secant(pwvcm, taug.dtype), jnp.asarray(_NGB, jnp.int32),
        dwg)
    band_sum = lambda rad: jnp.zeros((ncol, 16), dt).at[:, _NGB].add(
        rad * dwg)
    out = dict(zip(_OUT_KEYS, res[:4]))
    if dudts:
        out["duflx_dts"], out["duflxc_dts"], toa, dtoa = res[4:]
        out["dolrb_dts"] = band_sum(dtoa)
    else:
        (toa,) = res[4:]
    out["olrb"] = band_sum(toa)
    return out


def rtrnmc_for_platform(semiss, taug, pfracs, cloudy, taucmc, planklay,
                        planklev, plankbnd, dplankbnd_dts, pwvcm,
                        dudts=True):
    """The Pallas kernel on a CUDA device, the jnp rtrnmc on the CPU.

    The choice is made when the step is lowered, from the platform it is
    lowered for; there is no default, so any other platform raises.
    """
    return lax.platform_dependent(
        semiss, taug, pfracs, cloudy, taucmc, planklay, planklev, plankbnd,
        dplankbnd_dts, pwvcm,
        cpu=partial(rtrnmc, dudts=dudts),
        cuda=partial(rtrnmc_triton, dudts=dudts))
