"""``chip_smoke.device_ms`` and ``device_kernels`` against a profiler that
loses a window's events.

On the card, torch.profiler now and then records only part of a window's
device events, or none, so a kernel's device time read 0 and the script
divided by it.  Here the profiler is replaced by a stand-in that drops
events on chosen windows, so the repair runs on the CPU: a window counts
only once another one recorded as many device events, and windows that
never agree raise instead of returning a low time.  ``device_kernels``
also skips counts that are not a whole number of calls.  Each window
starts with sentinel kernels that take the events the profiler drops at
a window's head, and they are left out of the counts.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


#: the head sentinel's kernel (``torch.cuda._sleep``)
SPIN = "_ZN2at4cuda12_GLOBAL__N_111spin_kernelEl"


class _Event:
    def __init__(self, device_type, count, us, key="_Z8k_kernelv"):
        self.device_type, self.count = device_type, count
        self.self_device_time_total = us
        self.key = key


def _fake_profiler(monkeypatch, windows):
    """Replace torch.profiler.profile: window i records the device events
    ``windows[i]`` (a list of (count, us)), plus one host event."""
    seen = []

    class Profile:
        def __init__(self, activities):
            self.i = len(seen)
            seen.append(self.i)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            cuda = torch.autograd.DeviceType.CUDA
            return ([_Event(cuda, *ev) for ev in windows[self.i]]
                    + [_Event(torch.autograd.DeviceType.CPU, 7, 999.0)])
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return seen


@pytest.mark.parametrize("windows,ms", [
    # every window whole: the second one, agreeing with the first, counts
    ([[(10, 500.0), (10, 300.0)], [(10, 520.0), (10, 300.0)]], 0.082),
    # the first window lost everything (a 0 reading before the repair)
    ([[], [(10, 500.0), (10, 300.0)], [(10, 510.0), (10, 300.0)]], 0.081),
    # the first lost part of its events: its count disagrees
    ([[(10, 500.0), (4, 120.0)], [(10, 500.0), (10, 300.0)],
      [(10, 500.0), (10, 310.0)]], 0.081),
    # one lossy window between two whole ones: the third agrees with the first
    ([[(10, 500.0), (10, 300.0)], [(6, 300.0)], [(10, 490.0), (10, 300.0)]],
     0.079),
    # the head sentinels (their counts differing) are left out
    ([[(8, 8.0, SPIN), (10, 500.0)], [(7, 7.0, SPIN), (10, 510.0)]], 0.051),
])
def test_device_ms_waits_for_two_agreeing_windows(monkeypatch, windows, ms):
    seen = _fake_profiler(monkeypatch, windows)
    calls = []
    got = chip_smoke.device_ms(lambda: calls.append(1), reps=10)
    assert got == pytest.approx(ms)
    assert len(seen) == len(windows)
    assert len(calls) == 1 + 10 * len(windows)   # one warm-up call


def test_device_ms_raises_when_no_windows_agree(monkeypatch):
    windows = [[]] + [[(i, 100.0 * i)] for i in range(1, 6)]
    _fake_profiler(monkeypatch, windows)
    with pytest.raises(RuntimeError, match="disagreed in every window"):
        chip_smoke.device_ms(lambda: None, reps=10, windows=6)


@pytest.mark.parametrize("windows,per_call", [
    # one launch a call, every window whole
    ([[(5, 40.0)], [(5, 41.0)]], 1.0),
    # the first window lost its events; a kernel and a copy a call after
    ([[], [(5, 40.0), (5, 9.0)], [(5, 40.0), (5, 9.0)]], 2.0),
    # two windows lost the same event: not a whole number of calls
    ([[(4, 32.0)], [(4, 32.0)], [(5, 40.0)], [(5, 40.0)]], 1.0),
    # the head sentinels took the dropped events and are not counted
    ([[(7, 7.0, SPIN), (5, 40.0)], [(6, 6.0, SPIN), (5, 40.0)]], 1.0),
])
def test_device_kernels_waits_for_two_agreeing_windows(monkeypatch, windows,
                                                       per_call):
    seen = _fake_profiler(monkeypatch, windows)
    n, names = chip_smoke.device_kernels(lambda: None, reps=5)
    assert n == per_call and len(seen) == len(windows)
    assert set(names) == {"k_kernel"}


def test_device_kernels_raises_when_no_windows_agree(monkeypatch):
    _fake_profiler(monkeypatch, [[(i, 10.0)] for i in range(1, 7)])
    with pytest.raises(RuntimeError, match="disagreed in every window"):
        chip_smoke.device_kernels(lambda: None, reps=5, windows=6)
