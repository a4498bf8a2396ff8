"""The stage readers (``perfbench/stages.py``) on span records and a
hand-made Chrome trace whose clock is a known offset from the host's,
and the stage report on the tiny kitchen on the CPU."""

from __future__ import annotations

import types

import pytest

from perfbench import stages
from vri_tpu_torch.runtime.profiler import SpanRecord

OFF = 100.0          # the host clock less the trace's, seconds
LAG = 20e-6          # a synchronize returns this long after the last end
JIT = 3e-6           # and the host reads its clock this long after that
MS = 1e-3


def _rec(name, parent, frame, s, e):
    return SpanRecord(name, parent, frame, round(s * 1e9), round(e * 1e9))


def _frame_records(base, frame, first):
    """A frame root at host time ``base`` (5 ms) and its five stages."""
    out = [_rec("frame", -1, frame, base, base + 5 * MS)]
    for k, name in enumerate(stages.STAGES):
        out.append(_rec(name, first, frame, base + (k + 0.1) * MS,
                        base + (k + 0.9) * MS))
    return out


class _Trace:
    def __init__(self):
        self.events, self.corr = [], 0

    def launch(self, host_t, start, dur, cat="kernel",
               name="cudaLaunchKernel"):
        """A runtime call at host time ``host_t`` and the device interval it
        launched, ``start`` and ``dur`` in host seconds."""
        self.corr += 1
        us = lambda t: (t - OFF) * 1e6                      # noqa: E731
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                            "ts": us(host_t), "dur": 3.0,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": f"k{self.corr}",
                            "ts": us(start), "dur": dur * 1e6,
                            "args": {"correlation": self.corr}})

    def sync(self, host_t, end):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": stages.HOST_SYNC,
                            "ts": (host_t - OFF) * 1e6,
                            "dur": (end - host_t) * 1e6,
                            "args": {"correlation": self.corr}})


def _stretch(jitter=(JIT, -JIT), outside=0):
    """Two frames 10 ms apart: one kernel launched in each stage and one in
    the root's own time, a copy in ``gbuffer``, the ``direct`` kernel
    running after its stage has closed; ``outside`` more kernels launched
    between the frames; the profiler's own synchronize at the end."""
    tr, recs, sync_ns = _Trace(), [], []
    for f in range(2):
        b = 1000.0 + 0.010 * f
        recs += _frame_records(b, f, len(recs))
        for k in range(5):
            start = b + (k + 0.5) * MS       # as soon as launched
            if stages.STAGES[k] == "direct":
                start = b + 3.2 * MS          # in the ``indirect`` span
            tr.launch(b + (k + 0.5) * MS, start, 0.2 * MS)
        tr.launch(b + 1.6 * MS, b + 1.8 * MS, 0.06 * MS, cat="gpu_memcpy",
                  name="cudaMemcpyAsync")
        tr.launch(b + 4.95 * MS, b + 5.0 * MS, 0.1 * MS)
        for j in range(outside):
            tr.launch(b + 6 * MS + j * 1e-6, b + 6.1 * MS, 1e-7)
        end = b + 6.1 * MS + 1e-7 if outside else b + 5.1 * MS
        tr.sync(b + (6.05 if outside else 4.96) * MS, end + LAG)
        sync_ns.append(round((end + LAG + jitter[f]) * 1e9))
    tr.sync(1000.5, 1000.5001)
    return tr.events, recs, sync_ns


def test_fit_clock_offset_and_residual():
    off, res = stages.fit_clock([10.0 + 5e-6, 20.0 - 5e-6, 30.0],
                                [2.0, 12.0, 22.0])
    assert off == pytest.approx(8.0, abs=1e-9)
    assert res == pytest.approx(5e-6, abs=1e-9)


@pytest.fixture
def two_bins(monkeypatch):
    """The hand-made frames hold seven launches, one of them queued: the
    placement looks at two stretches of each frame."""
    monkeypatch.setattr(stages, "PLACE_BINS", 2)


def test_stretch_d_clock_and_launch_attribution(two_bins):
    events, recs, sync_ns = _stretch()
    d = stages.device_stages(events, recs, sync_ns)
    assert "fault" not in d
    # fit on the synchronize calls' ends
    assert d["clock_offset_s"] == pytest.approx(OFF, abs=1e-7)
    assert d["clock_residual_s"] == pytest.approx(JIT, abs=1e-7)
    assert d["placement_residual_s"] == pytest.approx(0.0, abs=1e-9)
    assert (d["frames"], d["frames_lost"], d["frames_unplaced"]) == (2, 0, 0)
    assert d["device_rate_off"] == 0.0
    assert d["kernels"] == 12 and d["in_frame_share"] == 1.0
    # the ``direct`` kernel ran in ``indirect``'s time: it stays direct's
    assert d["launches"] == {s: 1.0 for s in stages.STAGES + ("frame",)}
    want = {s: 0.2 for s in stages.STAGES}
    want.update(gbuffer=0.26, frame=0.1)
    assert d["device_ms"] == pytest.approx(want)
    assert d["busy_s"] == pytest.approx(2 * 1.16 * MS)
    idle = d["idle_s"]
    # each frame's window runs from its span's start to its return, its
    # device work placed so that none starts before its launch: the root's
    # own idle time is the start to the first kernel; the copy's end to the
    # direct kernel began in ``gbuffer``; the last end to the return, after
    # the root closed
    assert d["window_s"] == pytest.approx(2 * (5.1 * MS + LAG))
    assert d["device_drift_s"] == pytest.approx(0.0, abs=1e-9)
    assert idle[stages.OUTSIDE] == pytest.approx(2 * LAG)
    assert idle["frame"] == pytest.approx(2 * 0.5 * MS)
    assert idle["gbuffer"] == pytest.approx(2 * (0.1 + 1.34) * MS)
    assert idle["visibility"] == pytest.approx(2 * 0.8 * MS)
    assert idle["indirect"] == pytest.approx(2 * 0.9 * MS)
    assert idle["history"] == pytest.approx(2 * 0.3 * MS)
    m = stages.metrics({"host_ms": {}, "device": d})
    assert m["direct_launches"] == 1.0
    assert m["gbuffer_device_ms"] == pytest.approx(0.26)


@pytest.mark.parametrize("lose", ["first", "last"])
def test_frames_the_trace_lost_are_left_out(lose, two_bins):
    """A kernel launch of one frame without its kernel record: the numbers
    cover the other frame alone; the clock still fits on both."""
    events, recs, sync_ns = _stretch()
    ks = [i for i, e in enumerate(events) if e["cat"] == "kernel"]
    k = ks[0] if lose == "first" else ks[-1]
    events = events[:k] + events[k + 1:]
    d = stages.device_stages(events, recs, sync_ns)
    assert (d["frames"], d["frames_lost"]) == (1, 1)
    assert d["kernels"] == 6 and d["in_frame_share"] == 1.0
    assert d["launches"] == {s: 1.0 for s in stages.STAGES + ("frame",)}
    assert d["clock_residual_s"] == pytest.approx(JIT, abs=1e-7)
    assert d["busy_s"] == pytest.approx(1.16 * MS)
    assert d["window_s"] == pytest.approx(5.1 * MS + LAG, abs=5e-6)
    assert d["idle_s"] is not None
    # lost in both frames: no numbers
    events, recs, sync_ns = _stretch()
    keep = [e for i, e in enumerate(events) if i not in (ks[0], ks[-1])]
    assert "fault" in stages.device_stages(keep, recs, sync_ns)


def test_a_record_placed_after_its_frame_returned_leaves_the_frame_out(
        two_bins):
    """A kernel record 10 ms late, past its frame's return: no placement
    holds that frame, so the numbers cover the other."""
    events, recs, sync_ns = _stretch()
    k = [i for i, e in enumerate(events) if e["cat"] == "kernel"][-1]
    events[k] = dict(events[k], ts=events[k]["ts"] + 10e3)
    d = stages.device_stages(events, recs, sync_ns)
    assert (d["frames"], d["frames_lost"], d["frames_unplaced"]) == (1, 0, 1)
    assert d["placement_residual_s"] == pytest.approx(0.0, abs=1e-9)
    assert d["launches"] == {s: 1.0 for s in stages.STAGES + ("frame",)}
    assert d["busy_s"] == pytest.approx(1.16 * MS)


def test_the_cards_clock_stepping_between_frames_moves_nothing(two_bins):
    """The second frame's device timestamps 1 ms behind the host's (a
    drifting conversion): each frame is placed by its own launches, so
    every number reads as without the step, which is reported."""
    events, recs, sync_ns = _stretch()
    want = stages.device_stages(events, recs, sync_ns)
    cut = (1000.005 - OFF) * 1e6
    drifted = [dict(e, ts=e["ts"] - 1e3) if e["cat"] in (
        "kernel", "gpu_memcpy") and e["ts"] > cut else e for e in events]
    got = stages.device_stages(drifted, recs, sync_ns)
    assert got["device_drift_s"] == pytest.approx(1e-3)
    for key in ("frames", "kernels", "launches", "in_frame_share"):
        assert got[key] == want[key]
    for key in ("device_ms", "idle_s"):
        assert got[key] == pytest.approx(want[key])
    assert got["busy_s"] == pytest.approx(want["busy_s"])


def _busy_stretch(drift):
    """Two frames of 5 ms, ten kernels launched in each stage 80 us apart,
    each starting 5 us after its launch on an idle card and running 20
    us, a copy queued behind the third; ``drift(t)`` is how far the
    trace's card timestamps lag the host's at host time ``t``."""
    tr, recs, sync_ns = _Trace(), [], []

    def card(host_t, dur):
        """(start, duration) of an interval as the trace's card clock
        gives them, in host seconds."""
        t0, t1 = host_t - drift(host_t), host_t + dur - drift(host_t + dur)
        return t0, t1 - t0

    for f in range(2):
        b = 1000.0 + 0.010 * f
        recs += _frame_records(b, f, len(recs))
        for k in range(5):
            for j in range(10):
                at = b + (k + 0.1) * MS + 20e-6 + j * 80e-6
                tr.launch(at, *card(at + 5e-6, 20e-6))
                if j == 2:
                    tr.launch(at + 1e-6, *card(at + 25e-6, 5e-6),
                              cat="gpu_memcpy", name="cudaMemcpyAsync")
        tr.sync(b + 4.95 * MS, b + 4.95 * MS + LAG)
        sync_ns.append(round((b + 4.95 * MS + LAG) * 1e9))
    tr.sync(1000.5, 1000.5001)
    return tr.events, recs, sync_ns


def test_a_steady_drift_of_the_cards_clock_is_placed():
    """The card's timestamps running 2% slow against the host's from the
    second frame on: each frame's line follows them, so the device times
    and the idle time by stage read as without the drift, to a
    microsecond, and the rate is reported."""
    want = stages.device_stages(*_busy_stretch(lambda t: 0.0))
    assert want["placement_residual_s"] == pytest.approx(0.0, abs=1e-9)
    got = stages.device_stages(*_busy_stretch(
        lambda t: 0.02 * max(t - 1000.008, 0.0)))
    assert got["frames"] == 2
    assert got["placement_residual_s"] < 1e-6
    assert got["device_rate_off"] == pytest.approx(0.02, rel=1e-3)
    assert got["device_drift_s"] == pytest.approx(0.02 * 0.00212, rel=0.05)
    assert got["launches"] == want["launches"]
    assert got["device_ms"] == pytest.approx(want["device_ms"], rel=1e-6)
    assert got["busy_s"] == pytest.approx(want["busy_s"], rel=1e-6)
    for name, s in want["idle_s"].items():
        assert got["idle_s"][name] == pytest.approx(s, abs=2e-6)
    # visibility's idle time: from its first kernel's start to the next
    # stage's first, less its ten kernels and the copy, in each frame
    assert want["idle_s"]["visibility"] == pytest.approx(
        2 * (1.0 * MS - 10 * 20e-6 - 5e-6))


@pytest.mark.parametrize("frames", [1, 2])
def test_a_jump_of_the_cards_clock_inside_a_frame_leaves_it_out(frames):
    """The card's timestamps jumping by 200 us halfway through a frame: no
    line places that frame, so it is left out; with both frames left
    out, stretch D gives no numbers."""
    want = stages.device_stages(*_busy_stretch(lambda t: 0.0))
    jumps = (1000.0125,) if frames == 1 else (1000.0025, 1000.0125)
    got = stages.device_stages(*_busy_stretch(
        lambda t: 200e-6 * sum(t > j and t < j + 0.0025 for j in jumps)))
    if frames == 2:
        assert "fault" in got and got["frames_unplaced"] == 2
        return
    assert (got["frames"], got["frames_unplaced"]) == (1, 1)
    assert got["placement_residual_s"] == pytest.approx(0.0, abs=1e-9)
    assert got["launches"] == want["launches"]
    assert got["device_ms"] == pytest.approx(want["device_ms"])
    for name, s in want["idle_s"].items():
        assert got["idle_s"][name] == pytest.approx(s / 2)


def test_self_time_of_nested_spans():
    recs = [_rec("frame", -1, 0, 0.0, 0.010), _rec("a", 0, 0, 0.001, 0.005),
            _rec("b", 1, 0, 0.002, 0.003), _rec("c", 0, 0, 0.006, 0.009),
            _rec("frame", -1, 1, 0.020, 0.021), _rec("a", 4, 1, 0.020, 0.021),
            _rec("sdf.emit", -1, -1, 0.030, 0.040)]
    own = stages.self_seconds(recs)
    assert own == pytest.approx({"frame": 0.003, "a": 0.004, "b": 0.001,
                                 "c": 0.003})
    index = stages.SpanIndex(recs)
    assert [index.open_at(t) for t in (0.0005, 0.0025, 0.004, 0.0095,
                                       0.015, 0.0205)] == [
        "frame", "b", "a", "frame", stages.OUTSIDE, "a"]


def test_readers_give_none_where_the_numbers_are_unsound(monkeypatch,
                                                        two_bins):
    events, recs, sync_ns = _stretch(jitter=(0.0, 120e-6))
    d = stages.device_stages(events, recs, sync_ns)
    assert d["clock_residual_s"] == pytest.approx(60e-6, abs=1e-7)
    m = stages.metrics({"host_ms": {"direct": 1.5}, "device": d})
    assert m["direct_host_ms"] == 1.5
    assert m["direct_launches"] is None and m["history_device_ms"] is None
    # under 99% of the kernels launched inside a frame root
    events, recs, sync_ns = _stretch(outside=1)
    d = stages.device_stages(events, recs, sync_ns)
    assert d["in_frame_share"] == pytest.approx(12 / 14)
    assert stages.metrics({"device": d})["visibility_launches"] is None
    # a synchronize too many (one inside a frame) parts no frame
    events, recs, sync_ns = _stretch()
    assert "fault" in stages.device_stages(events, recs, sync_ns[:1])
    # no spans in the context; a program without the recording
    assert stages.read(types.SimpleNamespace(), "direct_host_ms") is None
    ctx = types.SimpleNamespace(stages={"stages": {"host_ms": {"direct": 2.0}},
                                        "setup": None})
    assert stages.read(ctx, "direct_host_ms") == 2.0
    assert stages.read(ctx, "sdf_emit_s") is None
    from vri_tpu_torch.runtime import profiler

    monkeypatch.delattr(profiler, "start_recording")
    assert stages.measure(None, None, cuda=False) is None


def test_setup_numbers_sum_device_intervals():
    recs = [SpanRecord("sdf.emit", -1, -1, 1, 2, 0.5, 2.5),
            SpanRecord("sdf.emit", -1, -1, 3, 4, 3.0, 3.5),
            SpanRecord("sdf.bake", -1, -1, 5, 6, 4.0, 5.0)]
    assert stages.setup_numbers(recs) == {"sdf_emit_s": 2.5,
                                          "sdf_bake_s": 1.0}
    assert stages.setup_numbers(recs[:1] + [SpanRecord(
        "sdf.bake", -1, -1, 5, 6)]) == {"sdf_emit_s": 2.0,
                                        "sdf_bake_s": None}


def test_stage_report_on_the_tiny_kitchen(tiny_bench):
    """The report of the tiny cell on the CPU, through the harness's
    traced run: the five stages' host times from the program's spans,
    both set-up spans recorded, the run's check passing, and every device
    number None without a card."""
    from perfbench import stage_report

    out = stage_report.report("kitchen49k.gi_static", 2 ** 31 + 11, 0.2,
                              pairs=2, device="cpu")
    m = out["metrics"]
    assert len(m) == 17
    for s in stages.STAGES:
        assert m[f"{s}_host_ms"] > 0
        assert m[f"{s}_launches"] is None and m[f"{s}_device_ms"] is None
    assert m["sdf_emit_s"] is None and m["sdf_bake_s"] is None
    assert out["setup_spans"] >= 2
    host = out["stages"]["host_ms"]
    assert set(host) == set(stages.STAGES) | {"frame"}
    assert host["frame"] < 0.1 * sum(host.values())
    assert set(out["host_ms_early"]) == set(host)
    assert out["checks"]["correct"] is True
    assert out["checks"]["stretch_h_early_pct_of_pairs_off"] is not None
    assert len(out["pairs_on_ms"]) == len(out["pairs_off_ms"]) == 2
