"""mux_ms_per_tick.stream: the window's wall time over the change in
StreamMultiplexer.ticks (serving/mux.py)."""


def read(ctx, win):
    raw = win.raw
    if not raw.get("ticks"):
        return None
    return 1e3 * raw["window_s"] / raw["ticks"]
