"""The 95th percentile of the intervals between consecutive train-loss
reads on the host over every step of the window (the first from the
window's start), in ms."""

import statistics


def read(run: dict):
    times = [run["t0"], *run["reads"]]
    gaps = [b - a for a, b in zip(times, times[1:])]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[18] * 1e3
