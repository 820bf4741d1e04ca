"""The 99th percentile of a frame's round trip, send to answer, on the
client's clock, over every frame answered in the window (the benchmark's
own span around each frame)."""

from portbench.traceread import quantile


def read(run):
    lat = run.window.get("frame_latency_s")
    if lat is None or len(lat) < 100:
        return None
    return 1000.0 * quantile(lat, 0.99)
