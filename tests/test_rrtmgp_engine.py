"""Native RRTMGP gas-optics engine tests (synthetic k-distribution).

No real RRTMGP coefficient file ships in this environment (zero
egress), so the engine is validated three ways:
  1. analytic limits with exact closed forms (constant tables ->
     tau = col_mix * k exactly; on-node inputs -> exact node values;
     linear tables -> exact interpolation),
  2. a brute-force per-cell numpy oracle implementing the interpolation
     independently (loops, no gathers) - catches layout/index bugs in
     the vectorized engine,
  3. Planck source sanity (constant fractions sum, linear totplnk).

Real files convert via tools/rrtmgp_ingest.py and run through the same
entry points.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geosradiation_gridcomp.models.rrtmgp import gas_optics as go

NT, NE, NP, NGPT, NBND = 5, 9, 12, 16, 2
GASES = ["h2o", "co2", "o3"]


def make_kdist(constant_k=None, seed=0):
    """Synthetic but structurally faithful k-distribution."""
    rng = np.random.default_rng(seed)
    press_ref = np.geomspace(103000.0, 100.0, NP)       # Pa descending
    temp_ref = np.linspace(160.0, 340.0, NT)
    if constant_k is not None:
        kmajor = np.full((NT, NE, NP + 1, NGPT), constant_k,
                         np.float32)
    else:
        t = np.linspace(0, 1, NT)[:, None, None, None]
        e = np.linspace(0, 1, NE)[None, :, None, None]
        p = np.linspace(0, 1, NP + 1)[None, None, :, None]
        g = np.linspace(0, 1, NGPT)[None, None, None, :]
        kmajor = (1e-22 * np.exp(0.8 * t + 0.5 * e - 1.2 * p + g)
                  ).astype(np.float32)
    vmr_ref = np.ones((2, len(GASES) + 1, NT))
    vmr_ref[:, 1] = 8e-3     # h2o
    vmr_ref[:, 2] = 4e-4     # co2
    vmr_ref[:, 3] = 5e-6     # o3
    # flavors: band 1 keyed by (h2o, co2), band 2 by (o3, dry)
    flavor = np.array([[1, 2], [3, 0]], np.int64)
    gpoint_flavor = np.zeros((2, NGPT), np.int64)
    gpoint_flavor[:, :8] = 1
    gpoint_flavor[:, 8:] = 2
    totplnk = np.linspace(10.0, 60.0, 30)[:, None] \
        * np.array([[0.6, 0.4]])
    planck_frac = np.full((NT, NE, NP + 1, NGPT), 1.0 / 8.0,
                          np.float32)
    minor = dict(
        kminor=(1e-23 * (1.0 + rng.random((NT, NE, 8)))
                ).astype(np.float32),
        gpt_limits=np.array([[1, 8]], np.int64),
        gas_idx=np.array([3], np.int64),          # o3 as minor in band1
        scales_with_density=np.array([False]),
        scaling_gas=np.array([0], np.int64),
        scale_by_complement=np.array([False]))
    return dict(
        gas_names=np.array(GASES), h2o_idx=np.int64(1),
        press_ref=press_ref, press_ref_trop=np.float64(9948.0),
        temp_ref=temp_ref, vmr_ref=vmr_ref, flavor=flavor,
        gpoint_flavor=gpoint_flavor, kmajor=kmajor,
        band_lims_gpt=np.array([[1, 8], [9, 16]], np.int64),
        band_lims_wvn=np.array([[10.0, 500.0], [500.0, 2000.0]]),
        minor_lower=minor, minor_upper=None,
        totplnk=totplnk, planck_frac=planck_frac,
        temp_ref_planck=np.linspace(160.0, 340.0, 30),
        solar_src=np.full(NGPT, 85.0),
        rayl=(1e-25 * np.ones((2, NT, NE, NGPT))).astype(np.float32))


def make_atmos(ncol=3, nlay=20, seed=1):
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 1, nlay + 1) ** 1.4
    plev = 2.0 * (101325.0 / 2.0) ** a
    plev = np.tile(plev, (ncol, 1)).astype(np.float64)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = (210.0 + 85.0 * (play / play[:, -1:]) ** 0.25
            + 2.0 * rng.standard_normal((ncol, nlay)))
    tlev = np.concatenate([tlay[:, :1],
                           0.5 * (tlay[:, 1:] + tlay[:, :-1]),
                           tlay[:, -1:]], axis=1)
    tsfc = tlay[:, -1] + 1.0
    vmrs = {"h2o": 5e-3 * (play / play[:, -1:]) ** 2 + 1e-6,
            "co2": np.full_like(play, 4.1e-4),
            "o3": 6e-6 * np.exp(-0.5 * ((np.log10(play) - 3.2)
                                        / 0.4) ** 2) + 2e-8}
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return (f32(play), f32(tlay), f32(plev), f32(tlev), f32(tsfc),
            {k: f32(v) for k, v in vmrs.items()})


def test_constant_kmajor_gives_colmix_times_k():
    """With kmajor == k0 everywhere, interpolation must be EXACT:
    tau = (col_gas1 + ratio*col_gas2) * k0 per g-point group."""
    k0 = 3e-22
    data = make_kdist(constant_k=k0)
    data["minor_lower"] = None
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos()
    taug, src = go.gas_optics_lw(data, play, tlay, plev, tlev, tsfc,
                                 vmrs)
    taug = np.asarray(taug, np.float64)
    # expected for band 1 (flavor h2o/co2): ratio = 8e-3/4e-4 = 20
    h2o = np.asarray(vmrs["h2o"], np.float64)
    _, col_dry = go.column_gas(np.asarray(plev, np.float64),
                               np.ones_like(h2o), h2o)
    col_dry = np.asarray(col_dry)
    cmix1 = col_dry * (h2o + 20.0 * 4.1e-4)
    want1 = cmix1 * k0
    got1 = taug[..., 0]
    rel = np.abs(got1 - want1) / want1
    assert rel.max() < 2e-5, rel.max()
    # band 2 (flavor o3/dry, ratio = 5e-6): cmix = col_o3 + 5e-6*col_dry
    o3 = np.asarray(vmrs["o3"], np.float64)
    want2 = (col_dry * o3 + 5e-6 * col_dry) * k0
    got2 = taug[..., 12]
    rel2 = np.abs(got2 - want2) / want2
    assert rel2.max() < 2e-5, rel2.max()


def test_constant_planck_frac_and_linear_totplnk():
    data = make_kdist(constant_k=1e-22)
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos()
    taug, src = go.gas_optics_lw(data, play, tlay, plev, tlev, tsfc,
                                 vmrs)
    pf = np.asarray(src["pfracs"])
    assert np.abs(pf - 1.0 / 8.0).max() < 1e-6
    # totplnk linear in T -> interpolation exact
    want = (10.0 + (np.asarray(tlay) - 160.0) / 180.0 * 50.0) * 0.6
    got = np.asarray(src["planklay"])[..., 0]
    assert np.abs(got - want).max() < 1e-3 * want.max()


def test_engine_matches_bruteforce_oracle():
    """Full smooth tables vs an independent per-cell loop oracle."""
    data = make_kdist()
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos(ncol=2, nlay=8)
    taug, _ = go.gas_optics_lw(data, play, tlay, plev, tlev, tsfc,
                               vmrs)
    taug = np.asarray(taug, np.float64)

    # ---- oracle ----
    press_ref = data["press_ref"]
    temp_ref = data["temp_ref"]
    kmajor = np.asarray(data["kmajor"], np.float64)
    vmr_ref = data["vmr_ref"]
    logp_ref = np.log(press_ref)
    dlogp = logp_ref[1] - logp_ref[0]
    dtemp = temp_ref[1] - temp_ref[0]
    h2o = np.asarray(vmrs["h2o"], np.float64)
    o3 = np.asarray(vmrs["o3"], np.float64)
    co2 = np.asarray(vmrs["co2"], np.float64)
    _, col_dry = go.column_gas(np.asarray(plev, np.float64),
                               np.ones_like(h2o), h2o)
    col_dry = np.asarray(col_dry)
    cols = {0: col_dry, 1: col_dry * h2o, 2: col_dry * co2,
            3: col_dry * o3}
    play_np = np.asarray(play, np.float64)
    tlay_np = np.asarray(tlay, np.float64)
    ncol, nlay = play_np.shape
    want = np.zeros((ncol, nlay, NGPT))
    for i in range(ncol):
        for k in range(nlay):
            lp = np.log(play_np[i, k])
            jt = int(np.clip((tlay_np[i, k] - temp_ref[0]) // dtemp,
                             0, NT - 2))
            ft = (tlay_np[i, k] - temp_ref[jt]) / dtemp
            jp = int(np.clip((lp - logp_ref[0]) // dlogp, 0, NP - 2))
            fp = (lp - logp_ref[jp]) / dlogp
            lower = play_np[i, k] > data["press_ref_trop"]
            p0 = jp + (0 if lower else 1)
            for g in range(NGPT):
                fl = data["gpoint_flavor"][0 if lower else 1, g] - 1
                g1, g2 = data["flavor"][fl]
                tau = 0.0
                for dt in range(2):
                    r = (vmr_ref[0 if lower else 1, g1, jt + dt]
                         / vmr_ref[0 if lower else 1, g2, jt + dt])
                    cmix = cols[g1][i, k] + r * cols[g2][i, k]
                    eta = cols[g1][i, k] / cmix if cmix > 0 else 0.5
                    le = eta * (NE - 1)
                    je = min(int(le), NE - 2)
                    fe = le - je
                    wt = (1 - ft) if dt == 0 else ft
                    for de in range(2):
                        we = (1 - fe) if de == 0 else fe
                        for dp in range(2):
                            wp = (1 - fp) if dp == 0 else fp
                            tau += cmix * wt * we * wp \
                                * kmajor[jt + dt, je + de, p0 + dp, g]
                want[i, k, g] = tau
    # minor contributor (band 1, no density scaling): interp in (t, eta)
    kminor = np.asarray(data["minor_lower"]["kminor"], np.float64)
    for i in range(ncol):
        for k in range(nlay):
            if not play_np[i, k] > data["press_ref_trop"]:
                continue
            jt = int(np.clip((tlay_np[i, k] - temp_ref[0]) // dtemp,
                             0, NT - 2))
            ft = (tlay_np[i, k] - temp_ref[jt]) / dtemp
            fl = 0                     # band-1 flavor
            g1, g2 = data["flavor"][fl]
            for dt in range(2):
                r = vmr_ref[0, g1, jt + dt] / vmr_ref[0, g2, jt + dt]
                cmix = cols[g1][i, k] + r * cols[g2][i, k]
                eta = cols[g1][i, k] / cmix if cmix > 0 else 0.5
                le = eta * (NE - 1)
                je = min(int(le), NE - 2)
                fe = le - je
                wt = (1 - ft) if dt == 0 else ft
                for de in range(2):
                    we = (1 - fe) if de == 0 else fe
                    want[i, k, :8] += cols[3][i, k] * wt * we \
                        * kminor[jt + dt, je + de, :]
    rel = np.abs(taug - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max() < 5e-5, rel.max()


def test_sw_rayleigh_and_source():
    data = make_kdist()
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos()
    taug, taur, src = go.gas_optics_sw(data, play, tlay, plev, vmrs)
    assert np.asarray(src).shape == (3, NGPT)
    assert float(np.asarray(src)[0, 0]) == 85.0
    # constant krayl: taur = 1e-25 * (col_dry + col_h2o) exactly
    h2o = np.asarray(vmrs["h2o"], np.float64)
    _, col_dry = go.column_gas(np.asarray(plev, np.float64),
                               np.ones_like(h2o), h2o)
    col_dry = np.asarray(col_dry)
    want = 1e-25 * (col_dry + col_dry * h2o)
    got = np.asarray(taur, np.float64)[..., 0]
    rel = np.abs(got - want) / want
    assert rel.max() < 2e-5


def test_native_kdist_end_to_end_isothermal():
    """KDistLWNative -> rte_lw_native on an isothermal opaque column:
    every flux equals the band-summed Planck source exactly (constant
    pfrac sums to 1 per band; totplnk linear in T)."""
    from geosradiation_gridcomp.models.rrtmgp.kdist import (
        KDistLWNative)
    from geosradiation_gridcomp.models.rrtmgp.gas_concs import (
        GasConcs)
    from geosradiation_gridcomp.models.rrtmgp.rte_native import (
        rte_lw_native)
    data = make_kdist(constant_k=5e-18)    # extremely opaque
    kd = KDistLWNative(data)
    assert kd.get_ngpt() == NGPT and kd.get_nband() == NBND
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos()
    t0 = 260.0
    tlay = jnp.full_like(tlay, t0)
    tlev = jnp.full_like(tlev, t0)
    tsfc = jnp.full_like(tsfc, t0)
    gas = GasConcs()
    for nm, v in vmrs.items():
        gas.set_vmr(nm, v)
    emis = jnp.ones((3, NBND), jnp.float32)
    taug, sources = kd.gas_optics(play * 0.01, tlay, plev * 0.01, tlev,
                                  tsfc, emis, gas)
    assert taug.shape == (3, tlay.shape[1], NGPT)
    out = rte_lw_native(taug, sources, emis, kd.get_band_lims_gpoint())
    b_tot = (10.0 + (t0 - 160.0) / 180.0 * 50.0)      # 0.6+0.4 bands
    uflx = np.asarray(out["uflx"])
    assert np.abs(uflx - b_tot).max() < 1e-2 * b_tot
    # down-flux: zero at TOA, grows monotonically, saturates at the
    # blackbody limit by the surface (band-2's key species o3 is thin
    # aloft, so saturation happens at depth, not immediately)
    dflx = np.asarray(out["dflx"])
    assert np.abs(dflx[:, 0]).max() == 0.0
    assert (np.diff(dflx, axis=1) > -1e-4).all()
    assert np.abs(dflx[:, -1] - b_tot).max() < 1e-2 * b_tot
    # band OLR split follows the totplnk band weights
    olrb = np.asarray(out["olrb"])
    assert np.abs(olrb[:, 0] / b_tot - 0.6).max() < 1e-2
    # transparent limit: k = 0 -> uflx = surface emission everywhere
    data0 = make_kdist(constant_k=0.0)
    data0["minor_lower"] = None
    data0["rayl"] = data0["rayl"] * 0
    kd0 = KDistLWNative(data0)
    taug0, src0 = kd0.gas_optics(play * 0.01, tlay, plev * 0.01, tlev,
                                 tsfc, emis, gas)
    out0 = rte_lw_native(taug0, src0, emis, kd0.get_band_lims_gpoint())
    assert np.abs(np.asarray(out0["uflx"]) - b_tot).max() < 1e-5 * b_tot
    assert np.abs(np.asarray(out0["dflx"])).max() < 1e-6


def test_ingest_roundtrip(tmp_path):
    """tools/rrtmgp_ingest.py reads an RRTMGP-layout NetCDF (written
    here with h5py) and produces the engine schema."""
    h5py = pytest.importorskip("h5py")
    import sys
    sys.path.insert(0, "tools")
    from rrtmgp_ingest import convert
    src = make_kdist()
    p = tmp_path / "fake-gas-lw.nc"
    with h5py.File(p, "w") as f:
        names = np.array([s.ljust(32).encode() for s in GASES])
        f["gas_names"] = names
        f["press_ref"] = src["press_ref"]
        f["press_ref_trop"] = src["press_ref_trop"]
        f["temp_ref"] = src["temp_ref"]
        f["vmr_ref"] = src["vmr_ref"]
        f["flavor"] = src["flavor"].T
        f["gpoint_flavor"] = src["gpoint_flavor"]
        f["kmajor"] = src["kmajor"]
        f["bnd_limits_gpt"] = src["band_lims_gpt"]
        f["bnd_limits_wavenumber"] = src["band_lims_wvn"]
        f["totplnk"] = src["totplnk"]
        f["plank_fraction"] = src["planck_frac"]
        f["kminor_lower"] = src["minor_lower"]["kminor"]
        f["minor_limits_gpt_lower"] = src["minor_lower"]["gpt_limits"]
        f["minor_gases_lower"] = np.array([b"o3".ljust(32)])
        f["scaling_gas_lower"] = np.array([b"".ljust(32)])
        f["minor_scales_with_density_lower"] = np.array([0], np.int8)
        f["scale_by_complement_lower"] = np.array([0], np.int8)
    out = tmp_path / "fake.npz"
    convert(str(p), str(out))
    d = np.load(out, allow_pickle=False)
    assert d["kmajor"].shape == (NT, NE, NP + 1, NGPT)
    assert int(d["h2o_idx"]) == 1
    assert d["minor_lower_gas_idx"][0] == 3


def test_ingest_reversed_layout_and_char_names(tmp_path):
    """The gpt-first (preserved-Fortran-axis-order) file variant and
    NetCDF char-array [n, strlen] gas names must ingest to the SAME npz
    as the C-order variant (the reference reads
    this file family at GEOS_SolarGridComp.F90:4609-4621)."""
    h5py = pytest.importorskip("h5py")
    import sys
    sys.path.insert(0, "tools")
    from rrtmgp_ingest import convert
    src = make_kdist()

    def write(path, rev):
        T = (lambda a: np.asarray(a).T) if rev else (lambda a: a)
        with h5py.File(path, "w") as f:
            if rev:
                # char-array form: [ngas, strlen] single chars
                f["gas_names"] = np.array(
                    [list(s.ljust(32)) for s in GASES], "S1")
                f["minor_gases_lower"] = np.array(
                    [list("o3".ljust(32))], "S1")
                f["scaling_gas_lower"] = np.array(
                    [list(" " * 32)], "S1")
            else:
                f["gas_names"] = np.array(
                    [s.ljust(32).encode() for s in GASES])
                f["minor_gases_lower"] = np.array([b"o3".ljust(32)])
                f["scaling_gas_lower"] = np.array([b"".ljust(32)])
            f["press_ref"] = src["press_ref"]
            f["press_ref_trop"] = src["press_ref_trop"]
            f["temp_ref"] = src["temp_ref"]
            f["vmr_ref"] = T(src["vmr_ref"])
            # flavor is [2, nflav] in the file; with this fixture's
            # nflav == 2 the transposed form is shape-ambiguous (real
            # coefficient sets have >= 9 flavors, where size detection
            # works), so both variants write the canonical orientation
            f["flavor"] = src["flavor"].T
            f["gpoint_flavor"] = T(src["gpoint_flavor"])
            f["kmajor"] = T(src["kmajor"])
            # 2 bands x 2 limits is shape-ambiguous like flavor above;
            # the [nmin, 2] minor limits below do exercise the reversal
            f["bnd_limits_gpt"] = src["band_lims_gpt"]
            f["bnd_limits_wavenumber"] = src["band_lims_wvn"]
            f["totplnk"] = T(src["totplnk"])
            f["plank_fraction"] = T(src["planck_frac"])
            f["kminor_lower"] = T(src["minor_lower"]["kminor"])
            f["minor_limits_gpt_lower"] = T(
                src["minor_lower"]["gpt_limits"])
            f["minor_scales_with_density_lower"] = np.array([0], np.int8)
            f["scale_by_complement_lower"] = np.array([0], np.int8)
            f["solar_source"] = src["solar_src"]
            f["rayl_lower"] = T(src["rayl"][0])
            f["rayl_upper"] = T(src["rayl"][1])

    pf, pr = tmp_path / "fwd.nc", tmp_path / "rev.nc"
    write(pf, False)
    write(pr, True)
    of, orv = tmp_path / "fwd.npz", tmp_path / "rev.npz"
    convert(str(pf), str(of))
    convert(str(pr), str(orv))
    df = np.load(of, allow_pickle=False)
    dr = np.load(orv, allow_pickle=False)
    assert set(df.files) == set(dr.files)
    for k in df.files:
        if df[k].dtype.kind in "SU":
            assert (df[k] == dr[k]).all(), k
        else:
            np.testing.assert_array_equal(df[k], dr[k], err_msg=k)


def test_minor_contributor_multi_flavor_range():
    """A minor contributor whose gpt range spans TWO flavors must
    resolve each g-point against ITS OWN flavor's eta weights
    (mo_gas_optics_rrtmgp resolves flavor per g-point; the per-range
    static loop in tau_minor groups by flavor). Brute-force check on a
    range straddling the band-1/band-2 flavor boundary."""
    data = make_kdist()
    # move the minor range to g-points 7..10: flavors (1, 1, 2, 2).
    # kminor is scaled so the contribution is ~10% of tau (with a tiny
    # kminor the f32 taug ulp swamps the subtraction this test does)
    rng = np.random.default_rng(7)
    data["minor_lower"] = dict(
        kminor=(1e-20 * (1.0 + rng.random((NT, NE, 4)))
                ).astype(np.float32),
        gpt_limits=np.array([[7, 10]], np.int64),
        gas_idx=np.array([3], np.int64),
        scales_with_density=np.array([False]),
        scaling_gas=np.array([0], np.int64),
        scale_by_complement=np.array([False]))
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos(ncol=2, nlay=6)
    taug, _ = go.gas_optics_lw(data, play, tlay, plev, tlev, tsfc, vmrs)
    data0 = dict(data, minor_lower=None)
    taug0, _ = go.gas_optics_lw(data0, play, tlay, plev, tlev, tsfc,
                                vmrs)
    dtau = np.asarray(taug, np.float64) - np.asarray(taug0, np.float64)
    # outside the range: no minor contribution
    assert np.abs(dtau[..., :6]).max() == 0.0
    assert np.abs(dtau[..., 10:]).max() == 0.0
    # inside: each g-point must match a brute-force interpolation with
    # the flavor that owns it
    names = [str(s) for s in data["gas_names"]]
    h2o = vmrs["h2o"]
    _, col_dry = go.column_gas(jnp.asarray(plev, jnp.float64),
                               jnp.ones_like(h2o), h2o)
    col_gas = [col_dry] + [col_dry * vmrs.get(nm, jnp.zeros_like(h2o))
                           for nm in names]
    st = go.InterpState(data, jnp.asarray(play, jnp.float64),
                        jnp.asarray(tlay, jnp.float64), col_gas)
    km = np.asarray(data["minor_lower"]["kminor"], np.float64)
    tropo = np.asarray(st.tropo)
    scaling = np.asarray(col_gas[3], np.float64)
    for j, g in enumerate(range(6, 10)):
        fl = int(data["gpoint_flavor"][0, g]) - 1
        want = np.zeros(play.shape)
        jt0 = np.asarray(st.jtemp)
        for dt in range(2):
            w0, w1 = st.fminor(fl, dt)
            jt = jt0 + dt
            je = np.asarray(st.jeta[fl][dt])
            w0 = np.asarray(w0, np.float64)
            w1 = np.asarray(w1, np.float64)
            for c in range(play.shape[0]):
                for l in range(play.shape[1]):
                    want[c, l] += (
                        w0[c, l] * km[jt[c, l], je[c, l], j]
                        + w1[c, l] * km[jt[c, l], je[c, l] + 1, j])
        want *= scaling * tropo
        got = dtau[..., g]
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        # tolerance is set by the f32 ulp of taug (~3.8e-6 at tau~30)
        # against a ~10% contribution; a wrong flavor would be O(1) off
        assert rel[tropo].max() < 5e-3, (g, rel.max())


def test_col_dry_absolute_value_and_setcoef_crosscheck():
    """Pin the molec/cm^2 convention: a 1013.25 hPa
    dry column holds ~2.148e25 molec/cm^2, and column_gas must agree
    with the RRTMG setcoef coldry formula for moist air."""
    plev = jnp.asarray([[101325.0, 0.0]])
    _, col_dry = go.column_gas(plev, jnp.ones((1, 1)),
                               jnp.zeros((1, 1)))
    expect = 101325.0 / (9.80665 * 0.028964) * 6.02214076e23 * 1e-4
    assert abs(float(col_dry[0, 0]) / expect - 1.0) < 1e-6
    assert 2.1e25 < float(col_dry[0, 0]) < 2.2e25

    # moist cross-check vs models/rrtmg/setcoef_lw.py:87-90
    # (coldry = dpz_hPa * 1e3 * AVOGAD / (1e2 * GRAV * amm * (1+h2o)))
    h2o = jnp.full((1, 1), 5e-3)
    _, col_moist = go.column_gas(plev, jnp.ones((1, 1)), h2o)
    AMD, AMW = 28.9660, 18.0160
    amm = (1.0 - 5e-3) * AMD + 5e-3 * AMW
    setcoef_val = 1013.25 * 1e3 * 6.02214076e23 / (
        1e2 * 9.80665 * amm * (1.0 + 5e-3))
    # conventions differ slightly (mass-weighted vs mole-fraction moist
    # molar mass, AMD 28.966 vs 28.964): agreement to ~1e-2 is the
    # contract; a 10x error is what this test guards against
    assert abs(float(col_moist[0, 0]) / setcoef_val - 1.0) < 1e-2


def test_dplankbnd_dts_is_segment_slope():
    """dplankbnd_dts must be the analytic slope of the active totplnk
    segment, not a 1 K finite difference straddling a node."""
    data = make_kdist(constant_k=1e-22)
    ncol, nlay = 2, 3
    play = jnp.full((ncol, nlay), 5e4)
    plev = jnp.linspace(1e5, 1e3, nlay + 1)[None, :].repeat(ncol, 0)
    tlay = jnp.full((ncol, nlay), 250.0)
    tlev = jnp.full((ncol, nlay + 1), 250.0)
    vmrs = {g: jnp.full((ncol, nlay), 1e-4) for g in GASES}
    tref = np.asarray(data["temp_ref_planck"], np.float64)
    dtp = tref[1] - tref[0]
    # tsfc 0.3 K below a node: the old one-sided secant spanned two
    # segments; the analytic slope equals the local segment slope
    tsfc = jnp.full((ncol,), float(tref[3]) - 0.3)
    _, src = go.gas_optics_lw(data, play, tlay, plev, tlev, tsfc, vmrs)
    totplnk = np.asarray(data["totplnk"], np.float64)
    expect = (totplnk[3] - totplnk[2]) / dtp
    np.testing.assert_allclose(np.asarray(src["dplankbnd_dts"][0]),
                               expect, rtol=1e-5)


def test_sw_native_night_columns_zeroed():
    """rte_sw_native zeroes night columns like rrtmg_sw."""
    from geosradiation_gridcomp.models.rrtmgp.rte_native import (
        rte_sw_native)
    ncol, nlay, ngpt = 4, 6, NGPT
    taug = jnp.full((ncol, nlay, ngpt), 0.1)
    taur = jnp.full((ncol, nlay, ngpt), 0.02)
    src = jnp.full((ncol, ngpt), 10.0)
    mu0 = jnp.asarray([0.8, 0.0, -0.3, 0.5])
    alb = jnp.full((ncol, NBND), 0.2)
    lims = np.array([[1, 8], [9, 16]], np.int64)
    out = rte_sw_native(taug, taur, src, mu0, alb, alb, lims)
    for k in ("flux_dn", "flux_up", "flux_dir", "flux_dn_clr",
              "flux_up_clr", "band_dn_sfc"):
        v = np.asarray(out[k])
        assert np.all(v[1] == 0.0) and np.all(v[2] == 0.0), k
        assert v[0].max() > 0.0 and v[3].max() > 0.0, k
