"""The rtrnmc Pallas kernel (Triton route) against the jnp rtrnmc.

On the CPU the kernel runs in the Pallas interpreter; the compiled kernel
is checked by the `gpu`-marked test, which skips where JAX finds no GPU.
The platform choice is checked by lowering the refresh's sweep for each
platform.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import col_err, count_collectives, sweep_inputs  # noqa
from geosradiation_gridcomp.parallel.sharding import (  # noqa: E402
    column_mesh, shard_columns)
from geosradiation_gridcomp.models.rrtmg.rtrnmc import rtrnmc  # noqa: E402
from geosradiation_gridcomp.models.rrtmg.rtrnmc_gpu import (  # noqa: E402
    BLOCK_COLS, KERNEL_NAME, _lane_chunks, rtrnmc_for_platform,
    rtrnmc_triton)


@pytest.fixture(scope="module", params=[(72, 6), (181, 5)],
                ids=["72lev", "181lev"])
def sweep(request):
    nlev, ncol = request.param
    return sweep_inputs(ncol, nlev)


@pytest.fixture
def gpu():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {devs[0].platform}")
    return devs[0]


@pytest.mark.parametrize("dudts", [True, False])
def test_kernel_interpret_matches_jnp(sweep, dudts):
    # BLOCK_COLS (4) does not divide ncol (6, 5): the last block is masked
    assert sweep[1].shape[0] % BLOCK_COLS
    want = rtrnmc(*sweep, dudts=dudts)
    got = rtrnmc_triton(*sweep, dudts=dudts, interpret=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert col_err(got[k], want[k]).max() < 1e-6, k


def test_kernel_partitioned_over_column_mesh():
    # each of 4 devices runs the kernel on its own 4 columns: no
    # collective, and the single-device result (the band sums outside the
    # kernel may round differently in the partitioned compile)
    args = sweep_inputs(16, 72)
    fn = jax.jit(lambda *a: rtrnmc_triton(*a, interpret=True))
    want = fn(*args)
    sharded = shard_columns(column_mesh(jax.devices()[:4]), args)
    compiled = fn.lower(*sharded).compile()
    assert count_collectives(compiled.as_text()) == {}
    got = compiled(*sharded)
    for k in want:
        assert got[k].sharding.spec[0] == "columns", k
        assert col_err(np.asarray(got[k]), np.asarray(want[k])).max() \
            < 1e-6, k


@pytest.mark.parametrize("n,chunks", [
    (140, ((0, 128), (128, 16))), (128, ((0, 128),)),
    (112, ((0, 64), (64, 64))), (17, ((0, 16), (16, 16)))])
def test_lane_chunks(n, chunks):
    assert _lane_chunks(n) == chunks


@pytest.mark.parametrize("platform,has_kernel", [("cuda", True),
                                                 ("cpu", False)])
def test_platform_choice(sweep, platform, has_kernel):
    traced = jax.jit(lambda *a: rtrnmc_for_platform(*a)).trace(*sweep)
    text = traced.lower(lowering_platforms=(platform,)).as_text()
    assert (KERNEL_NAME in text) == has_kernel


def test_platform_choice_rejects_other_platforms(sweep):
    traced = jax.jit(lambda *a: rtrnmc_for_platform(*a)).trace(*sweep)
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))


def test_cpu_choice_is_the_jnp_sweep(sweep):
    got = jax.jit(lambda *a: rtrnmc_for_platform(*a))(*sweep)
    want = jax.jit(lambda *a: rtrnmc(*a))(*sweep)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.gpu
def test_kernel_compiled_matches_jnp(gpu, sweep):
    args = jax.device_put(sweep, gpu)
    want = jax.jit(lambda *a: rtrnmc(*a))(*args)
    got = jax.jit(lambda *a: rtrnmc_triton(*a))(*args)
    for k in want:
        assert col_err(np.asarray(got[k]), np.asarray(want[k])).max() \
            < 1e-5, k
