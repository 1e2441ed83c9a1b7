"""The reading of a profile, on events made up to the shape the profiler
gives: device-busy union, idle gaps named by the host operation, kernel
names, and the image's readbacks found through the runtime call that
issued them."""

from __future__ import annotations

import pytest

from rtbench import profiling


class Event:
    def __init__(self, name, start, end, device="CPU", activity="cpu_op",
                 corr=0, shapes=(), thread=1):
        self._v = (name, start, end, device, activity, corr, shapes, thread)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def duration_ns(self): return self._v[2] - self._v[1]
    def device_type(self): return "DeviceType." + self._v[3]
    def activity_type(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def shapes(self): return [list(s) for s in self._v[6]]
    def start_thread_id(self): return self._v[7]
    def is_user_annotation(self): return self._v[4] == "user_annotation"


IMAGE = (18, 32, 3)


def events():
    gpu = dict(device="CUDA")
    return [
        Event(profiling.WINDOW, 0, 1000, activity="user_annotation"),
        Event(profiling.FRAME, 0, 1000, activity="user_annotation"),
        Event("aten::mul", 10, 40),
        Event("cudaLaunchKernel", 20, 30, activity="cuda_runtime", corr=1),
        Event("void at::native::vectorized_elementwise_kernel<4, F>(int, F)",
              100, 300, activity="kernel", corr=1, **gpu),
        Event("aten::copy_", 500, 900, shapes=(IMAGE, IMAGE)),
        Event("cudaMemcpyAsync", 510, 890, activity="cuda_runtime", corr=2),
        # the device copy appears to start after the host op: clocks differ
        Event("Memcpy DtoH (Device -> Pageable)", 905, 960, activity="gpu_memcpy",
              corr=2, **gpu),
        Event("aten::item", 300, 400, shapes=((1,),)),
        Event("cudaMemcpyAsync", 310, 320, activity="cuda_runtime", corr=3),
        Event("Memcpy DtoH (Device -> Pageable)", 320, 330, activity="gpu_memcpy",
              corr=3, **gpu),
        Event("(anonymous namespace)::perlane_closest_sweep_kernel(float const*)",
              250, 350, activity="kernel", corr=4, **gpu),
        Event("gpu annotation", 0, 1000, activity="gpu_user_annotation", **gpu),
    ]


def test_a_profile_is_read():
    tr = profiling.Trace(events(), frames=2)
    assert [d.kind for d in tr.device] == ["kernel", "kernel", "memcpy", "memcpy"]
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_intervals() == [[100, 350], [905, 960]]
    assert tr.busy_s() == pytest.approx(305e-9)
    readbacks = tr.copies_during(IMAGE)
    assert [(d.start, d.end) for d in readbacks] == [(905, 960)]
    assert tr.kernel_ms_per_frame(lambda n: n == "perlane_closest_sweep_kernel") == \
        pytest.approx(100e-6 / 2)
    names = dict(tr.device_ops())
    assert set(names) == {"at::native::vectorized_elementwise_kernel",
                          "perlane_closest_sweep_kernel",
                          "Memcpy DtoH (Device -> Pageable)"}
    gaps = dict(tr.idle_gaps())
    # the middles of [0, 100) and [960, 1000) fall between host operations
    assert gaps["python (Renderer.step)"] == pytest.approx(140e-9)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(555e-9)   # the innermost
    b = profiling.breakdown(tr)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_profile_without_its_window_is_refused():
    with pytest.raises(RuntimeError, match="rtbench.window"):
        profiling.Trace(events()[1:], frames=1)


@pytest.mark.parametrize("name, short", [
    ("void at::native::reduce_kernel<512, 1, R>(R)", "at::native::reduce_kernel"),
    ("(anonymous namespace)::block_stats_kernel(float const*, long long)",
     "block_stats_kernel"),
])
def test_kernel_names(name, short):
    assert profiling.short_name(name) == short
