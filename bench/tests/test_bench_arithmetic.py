"""The yardstick's arithmetic against cases worked by hand: roofline
bytes and operations, percentiles, the trace's busy time and idle
gaps."""

import pytest

from bench.lib import roofline, stats
from bench.lib.trace import Trace


def test_exchange_cost_by_hand():
    # 2 launches of 3 rows x 4 chips x 8 slots = 96 slots, 4 destinations:
    # valid lanes 96 B in and 3 x 4 x 16 = 192 B out, enables 16 B, drop
    # counts 12 x 4 B a launch; 10 valid events (label and forward entry,
    # 8 B each) and 7 kept (reverse entry and output label, 8 B each).
    nbytes, ops = roofline.exchange_cost(
        launches=2, slots=96, n_dst=4, enables=16, out_slots=192,
        out_rows=12, valid=10, kept=7)
    assert nbytes == 2 * (96 + 16 + 192 + 48) + 80 + 56
    assert ops == 10 * (10 * 4 + 2 * 192)
    # Empty slots cost their valid byte alone: more slots, same events.
    wider, _ = roofline.exchange_cost(
        launches=2, slots=192, n_dst=4, enables=16, out_slots=192,
        out_rows=12, valid=10, kept=7)
    assert wider - nbytes == 2 * 96


def test_merge_cost_by_hand():
    # One launch, 10 slots in and 4 out (a valid byte each), 2 rows of
    # drop counts, 3 kept events: label, reverse entry, output label and,
    # timed, the time read and written.
    nbytes, ops = roofline.merge_cost(launches=1, slots=10, out_slots=4,
                                      out_rows=2, kept=3, timed=True)
    assert nbytes == 10 + 4 + 2 * 4 + 3 * (4 + 4 + 4 + 8)
    assert ops == 10 * (4 + 3)
    nbytes, _ = roofline.merge_cost(launches=1, slots=10, out_slots=4,
                                    out_rows=2, kept=3, timed=False)
    assert nbytes == 10 + 4 + 2 * 4 + 3 * 12


def test_roofline_share_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB at 3.35 TB/s is 1 ms; 67 GFLOP at 67 TFLOP/s is 1 ms.
    assert roofline.share(3_350_000_000, 0, 2e-3, kind) == pytest.approx(50)
    assert roofline.share(0, 67_000_000_000, 4e-3, kind) == pytest.approx(25)
    assert roofline.share(1, 1, 0.0, kind) is None
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


def test_percentile_by_hand():
    xs = [5, 1, 4, 2, 3]                       # sorted 1..5
    assert stats.percentile(xs, 50) == 3
    assert stats.percentile(xs, 95) == pytest.approx(4.8)   # rank 3.8
    assert stats.percentile(xs, 0) == 1 and stats.percentile(xs, 100) == 5
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_trace_busy_time_and_gaps_by_hand():
    t = Trace()
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::cumsum", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 40, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 42, "dur": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60,
         "dur": 10},
    ]
    t.add(ev)
    # Device busy over [10, 35] + [42, 50] + [60, 70] = 43 us.
    assert t.busy_s == pytest.approx(43e-6)
    assert t.device_ops == 4
    assert t.kernels["k1"] == [2, pytest.approx(28e-6)]
    # Gap [35, 42] begins inside aten::cumsum only; [50, 60] too.
    assert t.gaps == {"aten::cumsum": pytest.approx(17e-6)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1"


def test_work_totals_sum_the_traced_calls():
    from bench.lib import readers

    counters = [{"launches": 64, "valid": 10, "kept": 7, "batch": 8},
                {"launches": 64, "kept": 5}, {}]
    assert readers.work_totals(counters) == {"launches": 128, "valid": 10,
                                             "kept": 12}
    assert readers.work_totals(None) == {}
