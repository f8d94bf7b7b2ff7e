"""The window's wall time over the train steps completed in it (all the
work of the window, evaluations, saves and batch waits included), in ms."""


def read(run: dict):
    return run["window_s"] / run["train_steps"] * 1e3 if run["train_steps"] else None
