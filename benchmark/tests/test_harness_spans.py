"""The readers of the program's `npe.*` spans, `metrics/host_ms.py` and
`metrics/idle_in_program.py`: on hand-built traces (nested waits, spans that
reach past the window, gaps partly covered, a program without the spans, a
renamed entry span),
and in a traced run of each cell on the CPU at a tiny width."""

import math
import time
from types import SimpleNamespace

import pytest

from benchmark import core
from benchmark.tests.test_harness_faults import CELLS, tiny_run
from benchmark.yardstick.trace import Trace

host_ms = core.reader("host_ms.edit")
idle_in_program = core.reader("idle_in_program.edit")


def run_of(kind, host, device=(), lo=0.0, hi=100.0, work=1):
    trace = Trace(device=[("k", s, e) for s, e in device], host=host, launches=0, lo=lo, hi=hi)
    return SimpleNamespace(profile=trace, traffic={"kind": kind}, work=work)


def test_readers_find_their_files_for_every_cell_that_lists_them():
    for part in ("edit", "encdec", "encdec.IANv1", "train"):
        assert core.reader(f"host_ms.{part}") is host_ms
        assert core.reader(f"idle_in_program.{part}") is idle_in_program


def test_host_ms_leaves_out_nested_waits_once():
    host = [("npe.paint_stroke", 0, 100), ("npe.wait", 10, 30), ("npe.wait", 15, 20), ("npe.stage", 5, 10),
            ("npe.wait", 50, 60), ("npe.unpack", 60, 70), ("npe.wait", 120, 130)]
    # 100 us less 20 + 10 us of waits, over two strokes
    assert host_ms.read(run_of("edit", host, work=2)) == pytest.approx(70 / 1e3 / 2)


def test_host_ms_leaves_out_the_programs_replays():
    host = [("npe.step.G", 0, 40), ("npe.replay", 10, 35), ("npe.wait", 30, 38), ("npe.step.D", 50, 90),
            ("npe.replay", 60, 95), ("npe.stage_chunk", 95, 100)]
    # G: 40 - [10, 38]; D: 40 - [60, 90]; the chunk's 5 us
    assert host_ms.read(run_of("train", host, work=2)) == pytest.approx((12 + 10 + 5) / 1e3 / 2)


def test_host_ms_clips_spans_that_reach_past_the_window():
    host = [("npe.paint_stroke", -50, 30), ("npe.wait", -40, 10), ("npe.paint_stroke", 80, 150),
            ("npe.wait", 90, 140), ("bench.paint_stroke", -60, 160)]
    # inside [0, 100]: 30 - 10 and 20 - 10 us
    assert host_ms.read(run_of("edit", host)) == pytest.approx((20 + 10) / 1e3)


def test_host_ms_takes_each_kinds_entry_spans():
    host = [("npe.encode_images", 0, 10), ("npe.sample_at", 20, 40), ("npe.wait", 30, 35), ("npe.infer", 50, 60),
            ("npe.step.G", 60, 70), ("npe.step.D", 70, 75), ("npe.stage_chunk", 80, 82), ("npe.wait", 81, 82)]
    assert host_ms.read(run_of("encdec", host)) == pytest.approx((10 + 20 - 5) / 1e3)
    assert host_ms.read(run_of("train", host)) == pytest.approx((10 + 5 + 2 - 1) / 1e3)
    with pytest.raises(RuntimeError, match="npe.paint_stroke"):
        host_ms.read(run_of("edit", host))  # no stroke in it, though the program records spans


def test_idle_in_program_counts_the_gaps_that_spans_cover():
    device = [(0, 10), (40, 70), (65, 90)]  # gaps [10, 40] and [90, 100]
    host = [("npe.paint_stroke", 5, 95), ("npe.wait", 20, 30), ("npe.stage", 25, 35), ("bench.paint_stroke", 0, 100),
            ("aten::copy_", 35, 40)]
    # [10, 40] covered over [10, 40] by the stroke; [90, 95] of [90, 100]
    assert idle_in_program.read(run_of("edit", host, device)) == pytest.approx(35.0)
    host = [("npe.stage", 12, 20), ("npe.wait", 18, 25), ("npe.replay", 38, 45), ("npe.unpack", 99, 130)]
    # [12, 25] and [38, 40] of the first gap, [99, 100] of the second
    assert idle_in_program.read(run_of("edit", host, device)) == pytest.approx(16.0)


def test_idle_in_program_is_at_most_the_idle_share():
    device = [(3, 7), (20, 21), (50, 80)]
    run = run_of("train", [("npe.step.G", -10, 200)], device)
    idle = 100.0 * (1.0 - run.profile.busy_s() / run.profile.window_s)
    assert idle_in_program.read(run) == pytest.approx(idle)


def test_a_program_without_spans_gives_nothing_to_read():
    host = [("bench.paint_stroke", 0, 100), ("cudaGraphLaunch", 10, 20)]
    for kind in ("edit", "encdec", "train"):
        run = run_of(kind, host, [(0, 5)])
        assert host_ms.read(run) is None and idle_in_program.read(run) is None
    run = run_of("edit", host)
    run.profile = None
    assert host_ms.read(run) is None and idle_in_program.read(run) is None


def test_a_program_whose_spans_miss_the_window_raises():
    host = [("bench.paint_stroke", 0, 100), ("npe.stroke", 10, 20), ("npe.wait", 120, 130)]
    with pytest.raises(RuntimeError):
        host_ms.read(run_of("edit", host))  # a renamed entry span
    assert idle_in_program.read(run_of("edit", host)) == pytest.approx(10.0)
    with pytest.raises(RuntimeError):
        idle_in_program.read(run_of("edit", host[:1] + host[2:]))  # spans, but none in the window


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(cell):
    run = tiny_run(cell, seconds=0.5)
    run.trace = True
    out = core.execute(run, time.perf_counter())
    part = cell.split("-", 1)[0] + (".IANv1" if cell == "encdec-IANv1-fp32" else "")
    host, idle = (out["metrics"][f"{m}.{part}"]["value"] for m in ("host_ms", "idle_in_program"))
    assert math.isfinite(host) and host > 0
    # no card: the window is all idle, and the spans cover part of it
    assert 0 < idle <= out["metrics"][f"idle_share.{part}"]["value"]
    assert out["correct"], out["checks"]
