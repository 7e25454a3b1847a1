"""The card readings under ``torch.profiler`` that the smoke and
``profile_port.py`` record: ``profile_port.card_ms`` takes a session only
when it recorded every call's device operations, and
``chip_smoke.device_kernels`` passes one launch per call only when a
session recorded every call (and reads nothing when none did). A session
that records part of the calls' events is made up here by a stand-in
profiler (the readings themselves need the card)."""

import contextlib

import pytest
import torch
from torch.autograd import DeviceType

import chip_smoke as cs
import profile_port as pp


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, us):
        self.name = name
        self.device_type = DeviceType.CUDA
        self.time_range = _Span(0.0, us)


def _fake_sessions(monkeypatch, sessions):
    """Each ``torch.profiler.profile`` session records the next entry of
    ``sessions``: a list of (name, us) device events."""
    it = iter(sessions)

    class _Prof:
        def events(self):
            return [_Event(n, us) for n, us in self.recorded]

    @contextlib.contextmanager
    def profile(activities=None):
        prof = _Prof()
        prof.recorded = next(it)
        yield prof

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def _calls(n, name="pcg_grid_kernel", us=10.0):
    return [(name, us)] * n


@pytest.mark.parametrize("sessions, expect", [
    ([_calls(1), _calls(20)], 10.0 / 1e3),          # a partial one retried
    ([_calls(2)] * 10, None),                        # never every call
    ([_calls(40)] * 10, None),                       # two launches per call
])
def test_card_ms_known_launches(monkeypatch, sessions, expect):
    _fake_sessions(monkeypatch, sessions)
    got = pp.card_ms(lambda: None, ["pcg_grid"], reps=20, per_call=1)
    assert got == expect


@pytest.mark.parametrize("sessions, expect", [
    ([_calls(40), _calls(40)], 20.0 / 1e3),         # two launches a call
    ([_calls(1), _calls(40), _calls(3), _calls(40)], 20.0 / 1e3),
    ([_calls(17), _calls(17)], 17 * 10.0 / 20 / 1e3),  # some calls launch
    ([_calls(40), _calls(20), _calls(20)] + [_calls(7)] * 7, None),
    ([_calls(n) for n in range(1, 11)], None),       # no count twice
])
def test_card_ms_learned_launches(monkeypatch, sessions, expect):
    _fake_sessions(monkeypatch, sessions)
    got = pp.card_ms(lambda: None, ["pcg_grid"], reps=20)
    assert got == pytest.approx(expect) if expect else got is None


def test_device_kernels_one_launch(monkeypatch):
    _fake_sessions(monkeypatch, [_calls(1, "linearize_kernel"),
                                 _calls(3, "linearize_kernel")])
    assert cs.device_kernels(lambda: None, ["linearize"]) == [
        "linearize_kernel"]


def test_device_kernels_not_measured(monkeypatch):
    """Five sessions that each record part of the calls: no reading."""
    _fake_sessions(monkeypatch, [_calls(1, "linearize_kernel")] * 5)
    assert cs.device_kernels(lambda: None, ["linearize"]) is None


@pytest.mark.parametrize("sessions", [
    [_calls(6, "linearize_kernel")],                 # two launches a call
    [_calls(1, "linearize_kernel"), _calls(4, "linearize_kernel")],
    [_calls(3, "linearize_rows_kernel")[:2]
     + _calls(1, "linearize_finish_kernel")],        # two kernels
])
def test_device_kernels_refuses(monkeypatch, sessions):
    _fake_sessions(monkeypatch, sessions + [[]] * 5)
    with pytest.raises(cs.SmokeFailure):
        cs.device_kernels(lambda: None, ["linearize"])
