"""K1's launch planning (``ops/stencil_cuda.py``: ``k1_route``, ``k1_plan``,
``k1_cost``), which is plain Python and runs without a GPU: the route is a
rule of the shape alone, a plan stays inside the card's limits and covers
every cell exactly once, and the cost function gives the bandwidth bounds
the measurements are held against.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openimpala_tpu_torch.ops import stencil_cuda as sc  # noqa: E402

EXTENTS = (1, 2, 3, 5, 97, 100, 129, 512, 1024)
DTYPES = (torch.float32, torch.float64)
MODES = ("matvec", "matvec_dot", "resid", "sweep", "restrict")
PERIODIC = tuple(itertools.product((False, True), repeat=3))
H100_BYTES_S = 3.35e12


def _shapes(mode):
    for shape in itertools.product(EXTENTS, repeat=3):
        if mode != "restrict" or all(n % 2 == 0 for n in shape):
            yield shape


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_is_a_rule_of_the_shape(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_stream = 0
    for shape in itertools.product(EXTENTS, repeat=3):
        for periodic in PERIODIC:
            route = sc.k1_route(shape, dtype, periodic)
            assert route in sc.K1_ROUTES
            assert route == sc.k1_route(shape, dtype, periodic)
            if route == "stream":
                n_stream += 1
                # the tensor map's stride rule, and whole vectors per thread
                assert shape[2] * itemsize % 16 == 0
                assert shape[2] * itemsize >= 512
                assert sc.k1_plan("matvec", shape, dtype,
                                  periodic).blocks >= sc.K1_MIN_BLOCKS
            # a misaligned base address never takes the vector loads
            assert sc.k1_route(shape, dtype, periodic,
                               aligned=False) == "general"
    assert n_stream > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_plan_stays_inside_the_cards_limits(mode, dtype):
    for shape in _shapes(mode):
        for periodic in ((False,) * 3, (True,) * 3, (False, True, False)):
            plan = sc.k1_plan(mode, shape, dtype, periodic)
            assert plan.smem <= sc.SMEM_BLOCK_MAX
            assert plan.threads <= 1024
            assert 1 <= plan.grid[0] < 2 ** 31
            assert 1 <= plan.grid[1] <= sc._GRID_YZ_MAX
            assert 1 <= plan.grid[2] <= sc._GRID_YZ_MAX
            assert plan.blocks == int(np.prod(plan.grid))
            if plan.route == "stream":
                assert plan.rows in (1, 2) and plan.run >= 1
                assert plan.tile == (sc.K1_WARPS * plan.rows,
                                     512 // (4 if dtype == torch.float32
                                             else 8))
                if mode == "restrict":
                    assert plan.rows == 2 and plan.run % 2 == 0


def _axis_cover(extent, step, blocks):
    """How often each index of an axis is owned when ``blocks`` blocks each
    own ``step`` consecutive indices, clipped to the extent."""
    count = np.zeros(extent, dtype=np.int64)
    for b in range(blocks):
        count[b * step:min((b + 1) * step, extent)] += 1
    return count


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_plan_covers_every_cell_exactly_once(mode, dtype):
    forced = [dict(route="stream", run=8), dict(route="stream", run=22),
              dict(route="stream", rows=2)]
    if mode != "restrict":
        forced.append(dict(route="stream", rows=1, run=7))
    for shape in _shapes(mode):
        plans = [sc.k1_plan(mode, shape, dtype)]
        if sc.k1_stream_takes(shape, dtype):
            plans += [sc.k1_plan(mode, shape, dtype, **kw) for kw in forced]
        for plan in plans:
            X, Y, Z = shape
            if plan.route == "general" and mode == "restrict":
                X, Y, Z = X // 2, Y // 2, Z // 2  # one thread a coarse cell
            ty, tz = plan.tile
            assert (_axis_cover(Z, tz, plan.grid[0]) == 1).all()
            assert (_axis_cover(Y, ty, plan.grid[1]) == 1).all()
            assert (_axis_cover(X, plan.run, plan.grid[2]) == 1).all()
            # and no block is empty
            assert (plan.grid[0] - 1) * tz < Z
            assert (plan.grid[1] - 1) * ty < Y
            assert (plan.grid[2] - 1) * plan.run < X


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periodic", [(False,) * 3, (True,) * 3])
@pytest.mark.parametrize("n", [256, 512, 1024])
def test_large_volumes_stream_and_fill_the_card(n, periodic, dtype):
    for mode in MODES:
        plan = sc.k1_plan(mode, (n, n, n), dtype, periodic)
        assert plan.route == "stream"
        assert plan.blocks >= 132  # one block per multiprocessor of an H100
        assert plan.run >= sc.K1_MIN_RUN
        if n >= 512:  # the X halo: two planes a run, at most 3.2 %
            assert plan.run >= sc.K1_RUN and 2 / plan.run <= 0.032
        # a thread owns two rows except at a periodic seam along Y or Z
        assert plan.rows == (2 if mode == "restrict" or not periodic[1]
                             else 1)


@pytest.mark.parametrize("shape,dtype", [
    ((64, 64, 64), torch.float32), ((64, 64, 64), torch.float64),
    ((100, 100, 100), torch.float32), ((128, 128, 128), torch.float32),
    ((512, 512, 97), torch.float32), ((512, 512, 130), torch.float32),
    ((512, 512, 65), torch.float64), ((512, 512, 64), torch.float32),
    ((1, 1, 1), torch.float64), ((3, 2, 1), torch.float32),
])
def test_small_and_awkward_volumes_take_the_general_route(shape, dtype):
    assert sc.k1_route(shape, dtype) == "general"
    plan = sc.k1_plan("matvec", shape, dtype)
    assert plan.route == "general" and plan.threads == 256
    assert plan.grid == (-(-shape[2] // 32), -(-shape[1] // 8),
                         -(-shape[0] // 8))


def test_plan_overrides_are_checked():
    f32 = torch.float32
    # a volume too small for the rule may still be forced onto the stream
    assert sc.k1_route((16, 24, 132), f32) == "general"
    plan = sc.k1_plan("sweep", (16, 24, 132), f32, route="stream")
    assert plan.route == "stream" and plan.grid == (2, 2, 1)
    assert sc.k1_plan("sweep", (512,) * 3, f32,
                      route="general").route == "general"
    with pytest.raises(ValueError, match="cannot take"):
        sc.k1_plan("matvec", (16, 24, 129), f32, route="stream")
    with pytest.raises(ValueError, match="cannot take"):
        sc.k1_plan("matvec", (512,) * 3, f32, aligned=False, route="stream")
    with pytest.raises(ValueError, match="rows"):
        sc.k1_plan("restrict", (512,) * 3, f32, rows=1)
    with pytest.raises(ValueError, match="run"):
        sc.k1_plan("restrict", (512,) * 3, f32, run=33)
    with pytest.raises(ValueError, match="route"):
        sc.k1_plan("matvec", (512,) * 3, f32, route="tma")
    with pytest.raises(ValueError, match="exceeds the grid"):
        sc.k1_plan("matvec", (8, 8 * 65536, 8), f32)


@pytest.mark.parametrize("mode,dtype,bound_ms", [
    ("matvec", torch.float32, 0.4006), ("matvec_dot", torch.float32, 0.4006),
    ("resid", torch.float32, 0.5609), ("sweep", torch.float32, 0.5609),
    ("restrict", torch.float32, 0.4207), ("matvec", torch.float64, 0.7212),
])
def test_cost_gives_the_recorded_bounds(mode, dtype, bound_ms):
    nbytes, flops = sc.k1_cost(mode, (512, 512, 512), dtype)
    assert round(nbytes / H100_BYTES_S * 1e3, 4) == bound_ms
    # bytes-bound by a wide margin: under 1.5 flops per byte
    assert 0 < flops / nbytes < 1.5
    per_cell = sc.k1_cost(mode, (1, 1, 1), dtype)[0]
    assert nbytes == per_cell * 512 ** 3


def test_constants_mirror_the_cuda_source():
    src = (Path(sc.CSRC) / sc.SOURCES["k1"]).read_text()
    assert int(re.search(r"constexpr int NW = (\d+);", src)[1]) == sc.K1_WARPS
    assert int(re.search(r"#define K1_STAGES (\d+)", src)[1]) == sc.K1_STAGES
    assert int(re.search(r"constexpr int XT = (\d+);", src)[1]) == 8
    # the stage of the plan is the Tile of the source: (rows + 2) rows of
    # 32 + 2 vectors, padded to 128 bytes, and 128 bytes to align the ring
    for dtype, rows in itertools.product(DTYPES, (1, 2)):
        plan = sc.k1_plan("matvec", (512,) * 3, dtype, rows=rows)
        stage = (sc.K1_WARPS * rows + 2) * 34 * 16
        assert plan.smem == sc.K1_STAGES * (-(-stage // 128) * 128) + 128
        assert plan.threads == (sc.K1_WARPS + 1) * 32


def test_stream_wrapper_refuses_cpu_tensors():
    x = torch.zeros((4, 4, 128))
    code = torch.zeros((4, 4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.k1_stencil("matvec", x, None, code, (1.0,) * 3, (False,) * 3,
                      route="stream")
