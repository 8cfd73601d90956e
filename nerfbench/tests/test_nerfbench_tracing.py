"""The traced window's readers on synthetic chrome traces."""
import pytest

from nerfbench.harness import spec, tracing


def x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def synthetic():
    """A 100 us window: kernels over [10, 30), [20, 40) (overlapping), a copy
    over [50, 60), a kernel from 95 past the window's end, one before it;
    the host in aten::mul over [40, 50) and in a span over [0, 100)."""
    return [
        x(tracing.WINDOW_SPAN, "user_annotation", 1000, 100),
        x("k_a", "kernel", 1010, 20), x("k_b", "kernel", 1020, 20),
        x("Memcpy DtoH", "gpu_memcpy", 1050, 10),
        x("k_tail", "kernel", 1095, 20), x("k_before", "kernel", 900, 50),
        x("nerfbench.train_iteration", "user_annotation", 1000, 100),
        x("aten::mul", "cpu_op", 1040, 10),
    ]


def test_union_of_overlapping_intervals():
    assert tracing.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert tracing.union_length([]) == 0


def test_idle_share_and_launches():
    w = tracing.from_chrome_trace(synthetic())
    assert w.seconds == pytest.approx(100e-6)
    # busy: [10, 40) + [50, 60) + [95, 100) = 45 us; the kernel before the
    # window is left out, the one across its end clipped
    assert w.busy_seconds() == pytest.approx(45e-6)
    w.units = 3
    assert w.idle_share() is None  # no measured window to divide by
    w.unit_seconds = 100e-6 / 3
    assert w.idle_share() == pytest.approx(0.55)
    assert spec.metric_reader("launches_per_step.train_kplanes").read(w) == 1
    assert spec.metric_reader("idle.train_kplanes").read(w) == pytest.approx(55.0)
    assert w.kernel_seconds(lambda n: n.startswith("k_")) == pytest.approx(45e-6)


def test_shares_divide_by_the_untraced_units():
    """The traced window ran slower than the measured one (the profiler's
    cost on the host): 15 us of device time a unit over 25 us a unit
    untraced is 40 % idle, not the traced window's 55 %; the MFU likewise
    takes the untraced unit's time."""
    w = tracing.from_chrome_trace(synthetic())
    w.units, w.unit_seconds = 3, 25e-6
    assert spec.metric_reader("idle.train_hash").read(w) == pytest.approx(40.0)
    w.work = {"model_flops": 3 * 989e12 * 25e-6 * 0.5}
    assert spec.metric_reader("mfu.train_kplanes").read(w) == pytest.approx(50.0)
    assert spec.metric_reader("mfu.render").read(w) == pytest.approx(50.0)


def test_window_from_synchronises_without_host_events():
    events = [x("cudaDeviceSynchronize", "cuda_runtime", 990, 10),
              x("cudaLaunchKernel", "cuda_runtime", 1001, 2),
              x("k", "kernel", 1010, 40),
              x("cudaDeviceSynchronize", "cuda_runtime", 1003, 97)]
    w = tracing.from_chrome_trace(events)
    assert (w.start, w.end) == (1000, 1100)
    assert w.busy_seconds() == pytest.approx(40e-6)


def test_breakdown_names_the_host_in_each_gap():
    w = tracing.from_chrome_trace(synthetic())
    bd = tracing.breakdown(w, w)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    # gaps [0, 10) and [60, 95) under the span alone, [40, 50) in aten::mul
    assert gaps["aten::mul"] == pytest.approx(10e-6)
    assert gaps["nerfbench.train_iteration"] == pytest.approx(45e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_reader_finds_nothing_to_read():
    w = tracing.Window()
    for name in ("idle.train_kplanes", "idle.render", "idle.view",
                 "launches_per_step.train_hash", "mfu.train_kplanes", "mfu.render",
                 "plane_roofline.train", "fused_roofline.render",
                 "host_ms_per_step.train_kplanes", "scatter_roofline.train"):
        assert spec.metric_reader(name).read(w) is None, name


def test_p95_is_over_every_request():
    assert tracing.p95(list(range(101))) == pytest.approx(95)
    assert tracing.p95([5.0] * 19 + [100.0]) == pytest.approx(9.75)
