"""mux_starved_share.stream, read from the port's spans (utils/profiling.py):
the share of the traced `mux.push` spans that enclose a `mux.starved` span,
and nothing, without raising, where no push was recorded or the port
counts no starved ticks."""

import pytest

import h100bench_tiny as tiny
from h100_bench import harness


def _reader():
    return harness.load_reader(tiny.REPO / "h100_bench",
                               "mux_starved_share.stream")


@pytest.mark.parametrize("pushes,starved,share", [
    (0, 0, None), (4, 0, 0.0), (4, 4, 100.0), (4, 1, 25.0)])
def test_starved_share_reads_the_ticks_that_found_the_card_idle(
        pushes, starved, share, monkeypatch):
    """Nothing without a recorded push, else the share of `mux.push` spans
    that enclose a `mux.starved` span (0 where none did); nothing from a
    port without spans or without `StreamMultiplexer.starved`."""
    from torch.profiler import ProfilerActivity, profile

    from msnv_tpu_torch.serving import mux
    from msnv_tpu_torch.utils import profiling
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(pushes):
            with profiling.span("mux.push"):
                if i < starved:
                    with profiling.span("mux.starved"):
                        pass
    reader = _reader()
    try:
        assert reader.read(None, None) == share
        with monkeypatch.context() as mp:
            mp.delattr(mux.StreamMultiplexer, "starved")  # the parent's pump
            assert reader.read(None, None) is None
        monkeypatch.delattr(profiling, "records")      # a port without spans
        assert reader.read(None, None) is None
    finally:
        profiling.clear()


def test_starved_share_counts_no_push_cut_by_the_window():
    """A push that opened before the profiler started is not recorded, and
    the `mux.starved` span inside it is not counted."""
    from torch.profiler import ProfilerActivity, profile

    from msnv_tpu_torch.utils import profiling
    profiling.clear()
    with profiling.span("mux.push"):             # no profiler: not recorded
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("mux.starved"):
                pass
            with profiling.span("mux.push"):
                with profiling.span("mux.starved"):
                    pass
            for _ in range(2):
                with profiling.span("mux.push"):
                    pass
    try:
        assert [len(profiling.records(n)) for n in ("mux.push",
                                                    "mux.starved")] == [3, 2]
        assert _reader().read(None, None) == pytest.approx(100.0 / 3)
    finally:
        profiling.clear()
