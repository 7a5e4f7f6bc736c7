"""Frame timing and throughput metering.

Reproduces the reference's observability surface: per-frame render time and
a once-per-second ``FPS: %.4lf, last render time: %.4f ms`` stdout line
(reference: src/ray-tracer.cpp:236-242), extended with a Mrays/s counter
(the benchmark metric, BASELINE.md).
"""

from __future__ import annotations

import time


class FrameTimer:
    """Aggregates frame times; emits the reference's FPS line once per second."""

    def __init__(self, print_fn=print, interval_s: float = 1.0):
        self._print = print_fn
        self._interval = interval_s
        self._frames = 0
        self._start = time.perf_counter()
        self.last_render_ms = 0.0

    def frame(self, render_ms: float) -> None:
        self._frames += 1
        self.last_render_ms = render_ms
        elapsed = time.perf_counter() - self._start
        if elapsed >= self._interval:
            fps = self._frames / elapsed
            # exact format of reference ray-tracer.cpp:239
            self._print(f"FPS: {fps:.4f}, last render time: {render_ms:.4f} ms")
            self._frames = 0
            self._start = time.perf_counter()


def mrays_per_s(n_pixels: int, seconds: float) -> float:
    """Primary rays per second in millions (BASELINE.md derived metric)."""
    return n_pixels / seconds / 1e6 if seconds > 0 else 0.0


def time_frames(render, cameras, windows: int = 5):
    """Per-frame time of ``render`` on the device: one warm-up frame, then
    ``windows`` timed windows, each enqueueing one frame per camera and
    ending in ``block_until_ready`` on all of them. Returns (median
    seconds per frame, every window's seconds per frame)."""
    import statistics

    import jax

    jax.block_until_ready(render(cameras[0]))
    per_frame = []
    for _ in range(windows):
        t0 = time.perf_counter()
        outs = [render(c) for c in cameras]
        jax.block_until_ready(outs)
        per_frame.append((time.perf_counter() - t0) / len(cameras))
    return statistics.median(per_frame), per_frame
