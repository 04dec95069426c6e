"""Port parity of B5, the one-hot product histogram variants
(``dmlc_core_tpu_torch/tools/spike_hist_floor.py``: the plain versions
behind ``kernel_variant`` on CPU tensors) against the JAX spike's Pallas
``_kernel_variant`` (``scripts/spike_hist_floor.py``, loaded as it is and
run in its own ``pallas_call`` with the script's BlockSpecs, in interpret
mode).

On order-exact g/h (g ∈ {±1, ±0.5}, h ∈ {0.5, 1}) every variant is
bit-equal: every sum, tile by tile and over the tiles, is exact in both,
and ``nodot``'s bf16 roundings round exact sums.  The product variants
(``shipped``, ``grpacc``, ``pack4``, ``pack8``) then also equal the JAX
``segment`` histogram in the factored layout.  On general g/h the product
variants agree within ``2^-16`` of the largest cell (the same bf16 values
summed in f32 in other orders), ``nodot`` within ``2^-7`` (its per-tile
bf16 roundings can fall on either side where the f32 sums differ in the
last place).
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.tools import spike_hist_floor as S  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

T = 128
PRODUCTS = ("shipped", "grpacc", "pack4", "pack8")
PRODUCT_TOL = 2.0 ** -16
NODOT_TOL = 2.0 ** -7


def _spike():
    spec = importlib.util.spec_from_file_location(
        "jax_spike_hist_floor", os.path.join(ROOT, "scripts",
                                             "spike_hist_floor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SPIKE = _spike()


def _jax_variant(bins, node, g, h, n_build, variant):
    """One pass of the script's ``_kernel_variant`` under its own
    BlockSpecs (``one_pass``), in interpret mode."""
    lo = jh._lo_factor(n_build, 256)
    hi = -(-256 // lo)
    fp, n = bins.shape
    kern = functools.partial(SPIKE._kernel_variant, n_nodes=n_build, hi=hi,
                             lo=lo, variant=variant)
    out = pl.pallas_call(
        kern,
        grid=(n // T,),
        in_specs=[
            pl.BlockSpec((fp, T), lambda i: (0, i)),
            pl.BlockSpec((1, T), lambda i: (0, i)),
            pl.BlockSpec((1, T), lambda i: (0, i)),
            pl.BlockSpec((1, T), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((fp, 2 * n_build * hi, lo),
                               lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((fp, 2 * n_build * hi, lo),
                                       jnp.float32),
        interpret=True,
    )(jnp.asarray(bins), jnp.asarray(node)[None], jnp.asarray(g)[None],
      jnp.asarray(h)[None])
    return np.asarray(out)


def _inputs(F, n, n_build, seed, exact):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 256, (F, n), dtype=np.uint8)
    # the spike's draw: node ids in [0, 2·n_build), plus masked rows
    node = rng.integers(-1, 2 * n_build, n, dtype=np.int32)
    if exact:
        g = rng.choice(np.array([-1.0, -0.5, 0.5, 1.0], np.float32), n)
        h = rng.choice(np.array([0.5, 1.0], np.float32), n)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.random(n).astype(np.float32)
    return bins, node, g, h


def _port(bins, node, g, h, n_build, variant):
    return S.kernel_variant(*(torch.from_numpy(a) for a in (bins, node, g, h)),
                            n_build, variant, tile_rows=T).numpy()


@pytest.mark.parametrize("variant", S.VARIANTS)
@pytest.mark.parametrize("n_build", [1, 2])
def test_bit_equal_to_jax_kernel_on_exact_gradients(variant, n_build):
    F, n = (8, 640) if n_build == 1 else (16, 1000)   # a partial last tile
    bins, node, g, h = _inputs(F, n, n_build, seed=n_build, exact=True)
    want = _jax_variant(bins, node, g, h, n_build, variant)
    got = _port(bins, node, g, h, n_build, variant)
    assert got.shape == want.shape == (F, 2 * n_build * 8, 32)
    assert got.tobytes() == want.tobytes()
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("variant", S.VARIANTS)
@pytest.mark.parametrize("n_build", [1, 2])
def test_close_to_jax_kernel_on_general_gradients(variant, n_build):
    F, n = (16, 768) if n_build == 1 else (8, 512)
    bins, node, g, h = _inputs(F, n, n_build, seed=10 + n_build,
                               exact=False)
    want = _jax_variant(bins, node, g, h, n_build, variant)
    got = _port(bins, node, g, h, n_build, variant)
    tol = NODOT_TOL if variant == "nodot" else PRODUCT_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n_build", [1, 2])
def test_product_variants_are_the_segment_histogram(n_build):
    F, n = 8, 1024
    bins, node, g, h = _inputs(F, n, n_build, seed=20 + n_build, exact=True)
    seg = jh.build_histogram(jnp.asarray(bins), jnp.asarray(node),
                             jnp.asarray(g), jnp.asarray(h), n_build, 256,
                             "segment", transposed=True)
    want = S.factored(torch.from_numpy(np.asarray(seg)), 32).numpy()
    for variant in PRODUCTS:
        got = _port(bins, node, g, h, n_build, variant)
        assert got.tobytes() == want.tobytes(), variant


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    bins, node, g, h = _inputs(8, 256, 1, seed=3, exact=True)
    before = dict(S.kernel_variant.launches)
    args = [torch.from_numpy(a) for a in (bins, node, g, h)]
    for variant in S.VARIANTS:
        a = S.kernel_variant(*args, 1, variant, tile_rows=T)
        b = S.kernel_variant_plain(*args, 1, variant, tile_rows=T)
        assert torch.equal(a, b)
    assert S.kernel_variant.launches == before     # no kernel launched


@pytest.mark.parametrize("bad", ["variant", "features", "rows"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    F, n = (5, 256) if bad == "features" else (8, 100 if bad == "rows"
                                                else 256)
    bins, node, g, h = _inputs(F, n, 1, seed=4, exact=True)
    with pytest.raises(Error):
        _port(bins, node, g, h, 1, "bogus" if bad == "variant"
              else "shipped")


@pytest.mark.parametrize("n_tiles,n_groups,sms", [
    (610, 3, 132), (610, 1, 132), (1, 3, 132), (7, 3, 2), (1000, 4, 3),
    (528, 1, 132), (529, 1, 132), (50, 40, 1)])
def test_tile_runs_cover_every_tile_once_in_order(n_tiles, n_groups, sms):
    """The kernel's blocks take runs of consecutive tiles: the runs cover
    every whole tile once, in order, none is empty, and the blocks of all
    feature groups are at most ``BLOCKS_PER_SM`` an SM (one a group where
    a single run exceeds that)."""
    per = S.tile_runs(n_tiles, n_groups, sms)
    runs = -(-n_tiles // per)
    tiles = [t for r in range(runs)
             for t in range(r * per, min(n_tiles, (r + 1) * per))]
    assert tiles == list(range(n_tiles))
    assert (runs - 1) * per < n_tiles
    assert runs * n_groups <= max(sms * S.BLOCKS_PER_SM, n_groups)


def test_prep_draws_the_jax_spikes_inputs():
    rows, feats = 3000, 9
    old = SPIKE.ROWS, SPIKE.FEATS
    SPIKE.ROWS, SPIKE.FEATS = rows, feats
    try:
        for n_build in (1, 2):
            want = SPIKE._prep(n_build)
            got = S._prep(n_build, rows, feats, "cpu")
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    finally:
        SPIKE.ROWS, SPIKE.FEATS = old


def test_run_level_times_every_pass_on_the_host():
    # one whole tile of the spike's 16384 rows, 8 of 9 features timed
    bins, node, g, h = S._prep(1, 16384 + 100, 9, "cpu")
    old = S.SLOPE_N, S.SLOPE_REPEATS
    S.SLOPE_N, S.SLOPE_REPEATS = (1, 2), 1
    try:
        for variant in ("prod", "shipped"):
            assert np.isfinite(S._run_level(bins, node, g, h, 1, variant))
    finally:
        S.SLOPE_N, S.SLOPE_REPEATS = old


def test_main_prints_the_jax_spikes_keys():
    env = {**os.environ, "SPIKE_ROWS": "16500", "SPIKE_FEATURES": "9"}
    res = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.spike_hist_floor",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["timer"] == "host_clock"
    assert out["rows"] == 16500 and out["tile"] == 16384
    for n_build in (1, 2):
        for variant in ("prod",) + S.VARIANTS:
            assert np.isfinite(out[f"nb{n_build}_{variant}_ms"])


def test_main_needs_a_gpu_unless_asked_for_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.spike_hist_floor"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "SPIKE_ROWS": "16384"})
    assert res.returncode != 0
    assert "no CUDA GPU" in res.stderr
