"""The model FLOPs of the work the traced window completed (train steps as
forward and backward, evaluations as forward, counted from shapes and real
edges by ``counts/<family>.py``) over the window's time at the card's dense
TF32 peak (``peaks.json``), in %."""


def read(run: dict):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0.0:
        return None
    flops = run["counts"].model_flops(run["settings"], run["shape"], run["train_steps"],
                                      run["eval_steps"])
    return flops / (run["window_s"] * run["peaks"]["tf32_flops"]) * 100.0
