"""chip_smoke.py's pieces on the CPU: the device gate, the comparisons,
the collective count, the compile-cache location, and the phases at a
tiny size (the phases take the device to run on)."""

import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from geosradiation_gridcomp import runtime  # noqa: E402


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cs.require_gpu()


def test_check_close_passes_identical_arrays():
    a = np.random.default_rng(0).normal(size=(50, 73)).astype(np.float32)
    cs.check_close("same", a, a.copy(), 0.0)
    cs.check_mean("same", a[:, 0], a[:, 0], 0.0)


@pytest.mark.parametrize("share,fails", [(0.0, True), (0.02, True),
                                         (0.05, False)])
def test_check_close_fails_beyond_tolerance(share, fails):
    want = np.ones((100, 10))
    got = want.copy()
    got[:4, 3] += 2e-3          # 4% of the columns beyond 1e-3
    if fails:
        with pytest.raises(AssertionError):
            cs.check_close("off", got, want, 1e-3, share)
    else:
        cs.check_close("off", got, want, 1e-3, share)


def test_check_mean_fails_beyond_tolerance():
    with pytest.raises(AssertionError):
        cs.check_mean("off", np.full(8, 1.0), np.zeros(8), 0.5)


def test_count_compiles():
    f = jax.jit(lambda x: x * 3.0 + 1.0)
    _, first = cs.count_compiles(lambda: f(np.ones(5, np.float32)))
    _, again = cs.count_compiles(lambda: f(np.ones(5, np.float32)))
    assert (first, again) == (1, 0)


def test_count_collectives():
    hlo = ("  %ag = f32[8] all-gather-start(f32[2] %p), dimensions={0}\n"
           "  %d = f32[8] all-gather-done(%ag)\n"
           "  %ar = f32[] all-reduce(f32[] %x), to_apply=%sum\n"
           "  %ar2 = f32[] all-reduce(f32[] %y), to_apply=%sum\n"
           "  %m = f32[8] multiply(%d, %d)\n")
    assert cs.count_collectives(hlo) == {"all-gather": 1, "all-reduce": 2}
    assert cs.count_collectives(hlo + ' op_name="mcica"', by_source=True) \
        == {("all-gather", "?"): 1, ("all-reduce", "?"): 2}
    assert cs.count_collectives("%m = f32[8] multiply(%a, %b)") == {}


def test_compile_cache_env_set_means_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.compile_cache_dir() == (str(tmp_path), False)
    assert runtime.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout_path(monkeypatch):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path, set_here = runtime.compile_cache_dir()
    assert set_here
    assert path == os.path.join(ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.use_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture(scope="module")
def main_path():
    cpu = jax.devices("cpu")[0]
    return cpu, cs.main_path_phase(cpu, ncol=64, nlev=72,
                                   times=cs.TIMES[:2])


def test_main_path_phase_on_cpu(main_path):
    _, (inp_h, kw, (sol, irr, ups), compiled) = main_path
    assert sol.flxn.shape == irr.flx.shape == (64, 73)
    assert len(ups) == 2 and ups[0]["dtdt"].shape == (64, 72)
    assert cs.count_collectives(compiled.as_text()) == {}


def test_reference_phase_on_cpu(main_path):
    cpu, (inp_h, kw, first, _) = main_path
    cs.reference_phase(cpu, cpu, inp_h, kw, first, nref=32)


def test_scheme_phase_on_cpu():
    cpu = jax.devices("cpu")[0]
    cs.scheme_phase(cpu, cpu, ncol=16)
