"""Kernel and graph launches (host calls) over the traced window's train
steps: one graph launch a step when the step is captured."""


def read(run: dict):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0.0 or not run["train_steps"]:
        return None
    return tr["launches"] / run["train_steps"]
