"""The least time of the window's flash work (``counts/<family>.py``: the
real edges' exps, products and bytes at the published peaks) over the
device time of the ``flash`` kernel group in the traced window, in %."""


def read(run: dict):
    tr = run["trace"]
    if not tr or tr["group_s"].get("flash", 0.0) <= 0.0:
        return None
    least = run["counts"].flash_least_s(run["settings"], run["shape"], run["train_steps"],
                                        run["eval_steps"], run["peaks"])
    return least / tr["group_s"]["flash"] * 100.0
