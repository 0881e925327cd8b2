"""The profiler helpers of ``repro_torch.benchmarks.bench_reduce`` that
``chip_smoke.py`` times its kernels with: retries, the difference between
a trace that missed the kernel and a profiler that recorded nothing at all,
and the CUDA-events fallback for the latter.  The profiler is replaced by a
fake that replays a script of traces, so these run on the CPU."""
from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from repro_torch.benchmarks import bench_reduce as br  # noqa: E402


def event(key, count=1, ms=0.5):
    return types.SimpleNamespace(
        key=key, count=count, device_type=DeviceType.CUDA,
        device_time_total=ms * 1e3, self_device_time_total=ms * 1e3)


@pytest.fixture
def traces(monkeypatch):
    """Install a fake profiler; returns the list of traces it replays
    (each a list of events; the last one repeats) and the traces taken."""
    script, taken = [], []

    class FakeProfile:
        def __init__(self, activities):
            self.activities = activities

        def __enter__(self):
            self.events = script[min(len(taken), len(script) - 1)]
            taken.append(self.activities)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return list(self.events)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(br, "PAD_S", 0.0)
    monkeypatch.setattr(br, "RETRY_S", 0.0)
    monkeypatch.setattr(br, "missed", {})
    monkeypatch.setattr(br, "lost", {})
    monkeypatch.setattr(br, "timed", {})
    monkeypatch.setattr(br, "event_timed", {})
    return script, taken


def test_kernel_ms_is_per_launch_from_the_profiler(traces):
    script, taken = traces
    script.append([event("noise"), event("my_kernel<1>", count=20, ms=3.0)])
    calls = []
    assert br.kernel_ms(lambda: calls.append(1), 10, "my_kernel") == \
        pytest.approx(0.15)
    assert len(taken) == 1 and len(calls) == 1 + 10
    assert br.ms_from("my_kernel") == "profiler"
    assert br.missed == {} and br.lost == {}


def test_trace_retries_a_trace_that_missed_the_kernel(traces):
    script, taken = traces
    script.extend([[], [event("noise")], [event("my_kernel")]])
    rows = br.device_activity(lambda: None, 4, "my_kernel")
    assert set(rows) == {"my_kernel"} and len(taken) == 3
    assert br.missed == {"my_kernel": 2} and br.lost == {}


def test_missing_kernel_beside_other_activity_raises_not_lost(traces):
    script, taken = traces
    script.append([event("other_kernel")])
    with pytest.raises(AssertionError, match="other_kernel") as info:
        br.device_activity(lambda: None, 1, "my_kernel")
    assert not isinstance(info.value, br.ProfilerLost)
    assert len(taken) == br.TRACES and br.lost == {}


def test_lost_profiler_falls_back_to_cuda_events(traces, monkeypatch):
    script, taken = traces
    script.append([])
    monkeypatch.setattr(br, "events_ms", lambda fn, reps: 1.25)
    assert br.kernel_ms(lambda: None, 10, "my_kernel") == 1.25
    assert len(taken) == br.TRACES
    assert br.lost == {"my_kernel": 1}
    assert br.ms_from("my_kernel").startswith("CUDA events")
    assert "1 of 1 timings" in br.ms_from("my_kernel")
    assert br.ms_from("other_kernel") == "profiler"
    # once lost, a later call gives up sooner
    assert br.kernel_ms(lambda: None, 10, "other_kernel") == 1.25
    assert len(taken) == br.TRACES + br.TRACES_AFTER_LOSS
    # a kernel timed by both says how many timings were events
    script.append([event("my_kernel", count=10, ms=1.0)])
    assert br.kernel_ms(lambda: None, 10, "my_kernel") == pytest.approx(0.1)
    assert "1 of 2 timings" in br.ms_from("my_kernel")


def test_device_ops_counts_by_kind_or_none_when_lost(traces):
    script, _ = traces
    script.append([event("Memcpy HtoD (Pageable -> Device)"),
                   event("my_kernel", count=2), event("Memset (Device)")])
    got = br.device_ops(lambda: None, traces=2)
    assert got["kernels"] == 2 and got["copies_to_device"] == 1
    assert got["memsets"] == 1 and got["copies_to_host"] == 0
    script.append([])
    script.pop(0)
    assert br.device_ops(lambda: None, traces=2) is None


def test_trace_takes_the_cpu_too_when_asked(traces):
    script, taken = traces
    script.append([event("flash_kernel")])
    prof = br.trace(lambda: None, 1, lambda p: True, "flash_kernel",
                    cpu=True)
    assert [e.key for e in prof.key_averages()] == ["flash_kernel"]
    assert set(taken[0]) == {torch.profiler.ProfilerActivity.CUDA,
                             torch.profiler.ProfilerActivity.CPU}
