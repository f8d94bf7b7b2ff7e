"""1 − the union of the device's kernel, copy and fill intervals over the
traced window's wall time (annotation ranges left out), in %."""


def read(run: dict):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0.0:
        return None
    return (1.0 - tr["busy_s"] / tr["trace_window_s"]) * 100.0
