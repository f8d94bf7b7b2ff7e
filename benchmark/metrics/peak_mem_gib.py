"""``torch.cuda.max_memory_allocated()`` over set-up, warm-up and window,
after ``reset_peak_memory_stats()`` at the process's start, in GiB."""


def read(run: dict):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
