"""The trace's reduction by the program's spans, and the K2 and K4 byte
tables."""

import pytest

from portbench import devtrace, roofline_k2_k4, spantrace


class _Event:
    def __init__(self, name, start, dur, device=False, thread=1):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._t = device, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_thread_id(self):
        return self._t


def _kernels():
    return [_Event(devtrace.ANSWER, 0, 1000),
            _Event("cudaLaunchKernel", 120, 10),
            _Event("aten::add", 450, 20),
            _Event("void (anonymous namespace)::k2_cells<float, 0>(...)",
                   150, 100, True),
            _Event("void (anonymous namespace)::k4_planes<float, 2, false>"
                   "(...)", 300, 50, True),
            _Event("elementwise", 500, 200, True),
            _Event(devtrace.ANSWER, 0, 1000, True)]


def _spans():
    return [_Event("oi/request/tortuosity#7", 0, 900),
            _Event("oi/props/solve", 100, 600),
            _Event("oi/solve/krylov", 200, 200),
            _Event("oi/solve/krylov", 420, 60),
            _Event("oi/props/solve", 100, 600, True),  # the range's copy
            _Event("oi/warmup", 0, 400, thread=2)]


def test_a_gap_goes_to_the_innermost_span_and_self_time_leaves_children():
    r = spantrace.reduce(_kernels() + _spans())
    s = r["spans"]
    # gaps: [0, 150) [250, 300) [350, 500) [700, 1000)
    assert r["idle_s"] == pytest.approx(650e-9)
    assert s["oi/request/tortuosity"]["calls"] == 1
    assert s["oi/request/tortuosity"]["idle_s"] == pytest.approx(100e-9 +
                                                                 200e-9)
    assert r["unspanned_idle_s"] == pytest.approx(300e-9)
    assert r["outside_idle_s"] == pytest.approx(100e-9)  # [900, 1000)
    assert s["oi/props/solve"]["idle_s"] == pytest.approx(50e-9 + 20e-9 +
                                                         20e-9)
    assert s["oi/solve/krylov"]["calls"] == 2
    assert s["oi/solve/krylov"]["idle_s"] == pytest.approx(
        50e-9 + 50e-9 + 60e-9)
    assert s["oi/solve/krylov"]["host_s"] == pytest.approx(260e-9)
    assert s["oi/props/solve"]["host_s"] == pytest.approx(600e-9)
    assert s["oi/props/solve"]["self_s"] == pytest.approx(340e-9)
    assert s["oi/request/tortuosity"]["self_s"] == pytest.approx(300e-9)
    # another thread's span: timed, but the idle goes to the requests'
    assert s["oi/warmup"]["self_s"] == pytest.approx(400e-9)
    assert s["oi/warmup"]["idle_s"] == 0.0
    assert sum(v["idle_s"] for v in s.values()) + r["outside_idle_s"] == \
        pytest.approx(r["idle_s"])
    assert r["k2_s"] == pytest.approx(100e-9)
    assert r["k4_s"] == pytest.approx(50e-9)
    assert r["requests_s"] == [pytest.approx(900e-9)]


def test_spans_leave_the_cell_reduction_as_it_was():
    bare = devtrace.reduce(_kernels())
    spanned = devtrace.reduce(_kernels() + _spans())
    assert set(bare) == set(spanned)
    for key in set(bare) - {"idle_gaps"}:
        assert spanned[key] == bare[key], key
    assert [s for _, s in spanned["idle_gaps"]] == \
        [s for _, s in bare["idle_gaps"]]
    assert spantrace.reduce(_spans()) == {}  # no window: nothing


PER_CELL = {("k2", "matvec", "f32"): 24, ("k2", "sweep", "f32"): 28,
            ("k2", "cheby", "f32"): 40, ("k2", "cheby", "f64"): 80,
            ("k2", "cheby_init", "f32"): 20, ("k2", "cheby_init", "f64"): 40,
            ("k4", "matvec", "f32"): 13, ("k4", "matvec_dot", "f32"): 13,
            ("k4", "matvec", "f64"): 25}


SHAPES = [(512, 512, 512), (128, 128, 256), (9, 96, 96, 96),
          (3, 32, 32, 32)]


@pytest.mark.parametrize("kernel,mode,dtype,shape", [
    k + (shape,) for k in sorted(PER_CELL) for shape in SHAPES
    if k[0] == "k4" or len(shape) == 3])  # K2 has no batch
def test_k2_and_k4_bytes_are_the_frozen_figures(kernel, mode, dtype, shape):
    cells = 1
    for v in shape:
        cells *= v
    name = f"{kernel}_{mode}_{dtype}"
    got = roofline_k2_k4.launch_bytes({(name, shape): 3,
                                       ("k1_matvec_f32", shape): 5}, kernel)
    assert got == 3 * PER_CELL[kernel, mode, dtype] * cells
