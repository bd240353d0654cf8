"""The generator and the yardstick: blobs from a seed, the traffic
stream, the K1 byte table and the trace's reduction."""

import types

import numpy as np
import pytest
import torch

from portbench import blobs, devtrace, harness, roofline, spec, traffic
from portbench.kinds import stratified


@pytest.mark.parametrize("n,porosity", [(32, 0.40), (48, 0.35), (64, 0.45)])
def test_same_seed_same_volume_and_porosity_on_target(n, porosity):
    seed = 2 ** 33 + 7
    a = blobs.blobs(n, porosity, blobs.seed_of(seed, 0), "cpu")
    b = blobs.blobs(n, porosity, blobs.seed_of(seed, 0), "cpu")
    c = blobs.blobs(n, porosity, blobs.seed_of(seed, 1), "cpu")
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert abs(float(a.double().mean()) - porosity) <= 1e-3


def test_stratified_porosities_are_the_same_set_for_every_seed():
    spec_ = dict(spec.cell(spec.load(), "tau512.xyz").traffic, n=128,
                 volumes=256, porosity=[0.35, 0.45])
    t1, t2 = traffic.make(spec_, 1), traffic.make(spec_, 2 ** 40 + 3)
    assert sorted(t1.porosities) == sorted(t2.porosities)
    assert t1.porosities != t2.porosities
    assert min(t1.porosities) > 0.35 and max(t1.porosities) < 0.45
    assert len(set(t1.volume_seeds)) == len(t1.volume_seeds)


def test_requests_walk_every_volume_and_direction():
    t = traffic.make(spec.cell(spec.load(), "tau512.xyz").traffic, 5)
    pairs = {(r.volume, r.direction) for r in
             (t.request(i, 5) for i in range(12))}
    assert len(pairs) == 12
    assert t.request(3, 5).seed == t.request(3, 5).seed
    assert [r.direction for r in t.warmup(5)] == ["X", "Y", "Z"]


# PERF.md section 6: compulsory bytes per cell of each K1 launch
PER_CELL = {("matvec", "f32"): 10, ("matvec_dot", "f32"): 10,
            ("resid", "f32"): 14, ("sweep", "f32"): 14,
            ("restrict", "f32"): 10.5, ("matvec", "f64"): 18,
            ("matvec_dot", "f64"): 18, ("resid", "f64"): 26,
            ("sweep", "f64"): 26, ("restrict", "f64"): 19}


@pytest.mark.parametrize("mode,dtype", sorted(PER_CELL))
def test_k1_bytes_at_512(mode, dtype):
    cells = 512 ** 3
    assert roofline.k1_bytes(mode, (512,) * 3, dtype) == \
        PER_CELL[mode, dtype] * cells
    name = f"k1_{mode}_{dtype}"
    assert roofline.parse_k1(name) == (mode, dtype)
    assert roofline.k1_launch_bytes({(name, "stream", (512,) * 3): 3}) == \
        3 * PER_CELL[mode, dtype] * cells


def test_k1_bytes_ignore_other_kernels():
    assert roofline.parse_k1("k2_matvec_f32") is None
    assert roofline.k1_launch_bytes({("k3_apply", "x", (8, 8, 8)): 5}) == 0


class _Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def activity_type(self):
        return "kernel" if self._dev else "cpu_op"


def test_trace_reduction_takes_the_union_of_streams():
    ev = [_Event(devtrace.ANSWER, 0, 1000, False),
          _Event("cudaGraphLaunch", 100, 300, False),
          _Event("aten::copy_", 700, 250, False),
          _Event("void k1_stream<float, 1>(...)", 100, 200, True),
          _Event("elementwise", 200, 200, True),  # overlaps: another stream
          _Event("Memcpy DtoH", 500, 100, True),
          _Event("late", 1200, 50, True),  # outside the window
          _Event(devtrace.ANSWER, 0, 1000, True),  # the range's copy
          _Event(devtrace.PROFILER, 620, 60, True)]  # the profiler's own
    r = devtrace.reduce(ev)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(400e-9)
    assert r["device_s"] == pytest.approx(500e-9)
    assert r["k1_s"] == r["hand_s"] == pytest.approx(200e-9)
    gaps = dict((n, s) for n, s in r["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(400e-9)
    assert gaps["after cudaGraphLaunch"] == pytest.approx(100e-9)
    assert r["idle_gaps"][0][1] >= r["idle_gaps"][-1][1]


def test_readers_leave_out_what_they_cannot_read():
    traced = types.SimpleNamespace(kind="rev_study", answers=[
        {"timings": {}, "graphs": {"reads": 0, "steps": 0},
         "launches": {}}], trace={})
    for m in spec.load()["per_layer"]:
        assert spec.reader("metrics", m["name"])(traced) is None, m["name"]


@pytest.mark.parametrize("n,per_group", [(3, [1, 1, 1]), (9, [3, 3, 3]),
                                         (4, [1, 1, 2]), (2, [0, 1, 1])])
def test_the_check_draws_evenly_over_groups(n, per_group):
    keys = [(v, d) for v in range(4) for d in "XYZ"]
    counts = []
    for seed in range(20):
        take = stratified(keys, lambda k: k[1], n,
                          np.random.default_rng(seed))
        assert len(take) == len(set(take)) == n
        counts.append(sorted(sum(1 for _, d in take if d == g)
                             for g in "XYZ"))
    assert all(c == per_group for c in counts)


def test_rev_and_whole_volume_tensors_have_metrics_of_their_own():
    window = types.SimpleNamespace(kind="rev_study", seconds=6.0,
                                   latencies=[2.0, 2.0, 2.0], results=27)
    assert spec.reader("end_to_end", "time_to_deff_s.rev")(window) == \
        pytest.approx(6.0 / 27)
    assert spec.reader("end_to_end", "time_to_deff_s")(window) is None


@pytest.mark.parametrize("flushes", [0, 2, None])
def test_cache_flushes_are_the_windows(flushes):
    window = harness.Window("effective_diffusivity", 51.0, [0.05], 1,
                            1, 1.0, flushes)
    read = spec.reader("metrics", "device.cache_flushes.lanes")
    assert read(harness.Traced("effective_diffusivity", [], {},
                               window)) == flushes
    assert read(harness.Traced("effective_diffusivity", [], {})) is None
    assert read(harness.Traced("tortuosity", [], {}, window)) is None
    rev = spec.reader("metrics", "device.cache_flushes.rev")
    assert rev(harness.Traced("rev_study", [], {}, window)) == flushes
    assert rev(harness.Traced("rev_study", [], {})) is None
    assert rev(harness.Traced("effective_diffusivity", [], {},
                              window)) is None
