"""mux_replay_share.stream, read from the port's spans (utils/profiling.py):
the share of the traced `mux.push` spans that enclose a `mux.replay` span,
and nothing, without raising, where no tick replayed or the port records
no spans."""

import pytest

import h100bench_tiny as tiny
from h100_bench import harness


def _ticks(pushes, replayed):
    """`pushes` spans `mux.push`, the first `replayed` of them enclosing a
    `mux.replay` span, recorded under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from msnv_tpu_torch.utils import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(pushes):
            with profiling.span("mux.push"):
                if i < replayed:
                    with profiling.span("mux.replay"):
                        pass


@pytest.mark.parametrize("pushes,replayed,share", [
    (0, 0, None), (4, 0, None), (4, 4, 100.0), (4, 1, 25.0)])
def test_replay_share_reads_the_ticks_that_replayed(pushes, replayed, share,
                                                   monkeypatch):
    """mux_replay_share.stream: nothing without spans or without a replay
    (a port without the graph), else the share of `mux.push` spans that
    enclose a `mux.replay` span."""
    from msnv_tpu_torch.utils import profiling
    profiling.clear()
    _ticks(pushes, replayed)
    reader = harness.load_reader(tiny.REPO / "h100_bench",
                                 "mux_replay_share.stream")
    try:
        assert reader.read(None, None) == share
        monkeypatch.delattr(profiling, "records")
        assert reader.read(None, None) is None     # a port without spans
    finally:
        profiling.clear()


def test_replay_share_counts_no_replay_outside_a_recorded_push():
    """A replay whose push opened before the profiler started is not
    counted: equal counts of both spans read 100 only where each replay
    lies inside a push."""
    from torch.profiler import ProfilerActivity, profile

    from msnv_tpu_torch.utils import profiling
    profiling.clear()
    with profiling.span("mux.push"):             # no profiler: not recorded
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("mux.replay"):
                pass
            with profiling.span("mux.push"):
                with profiling.span("mux.replay"):
                    pass
            with profiling.span("mux.push"):
                pass
    reader = harness.load_reader(tiny.REPO / "h100_bench",
                                 "mux_replay_share.stream")
    try:
        assert [len(profiling.records(n)) for n in ("mux.push",
                                                    "mux.replay")] == [2, 2]
        assert reader.read(None, None) == 50.0
    finally:
        profiling.clear()
