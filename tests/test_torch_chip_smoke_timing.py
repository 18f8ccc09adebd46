"""``chip_smoke.device_time_ms`` against a stand-in profiler: the
profiler can drop kernel records where calls launch small kernels back
to back, so a kernel's time is the mean over the records kept, times
its launches a call; a window that keeps under half is measured again,
and after three such windows the call is timed by events."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


class _Record:
    def __init__(self, key, count, total_us):
        self.key, self.count, self.self_device_time_total = key, count, total_us
        self.device_type = torch.autograd.DeviceType.CUDA


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    windows = []

    class _Profile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return windows.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Profile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_time_ms", lambda fn, reps: 9.0)
    yield chip_smoke, windows
    sys.modules.pop("chip_smoke", None)


@pytest.mark.parametrize("windows, kwargs, want", [
    # every record kept: the mean a call
    ([[_Record("k", 50, 50 * 20.0)]], dict(per_call=1), 0.02),
    # 40 of 50 kept, as phase 7 once saw: the mean of those kept
    ([[_Record("k", 40, 40 * 20.0)]], dict(per_call=1), 0.02),
    # two kernels, no per_call: one a call (40 of 50 kept) and two a call
    ([[_Record("a", 40, 40 * 20.0), _Record("b", 100, 100 * 5.0)]], {}, 0.03),
    # more records than launches, then a whole window; others filtered out
    ([[_Record("k", 60, 60.0)], [_Record("k", 50, 50 * 30.0), _Record("x", 5, 1.0)]],
     dict(per_call=1, name="k"), 0.03),
    # under half kept three times: events
    ([[_Record("k", 10, 10.0)]] * 3, dict(per_call=1), 9.0),
    # nothing recorded three times: events
    ([[]] * 3, {}, 9.0),
])
def test_device_time_ms_takes_the_mean_over_records_kept(smoke, windows, kwargs, want):
    chip_smoke, queue = smoke
    queue[:] = list(windows)
    got = chip_smoke.device_time_ms(lambda: None, 50, **kwargs)
    assert got == pytest.approx(want, rel=1e-12)
    assert not queue
