"""The device seconds of the work launched inside the program's
``han.eval_step`` spans over all device seconds in the traced window
(kernels, copies, fills; ``benchmark/spans.py``), in %."""

from benchmark import spans


def read(run: dict):
    rec = spans.reading(run)
    if rec is None or "han.eval_step" not in rec["spans"] or rec["device_s"] <= 0.0:
        return None
    return rec["spans"]["han.eval_step"]["device_s"] / rec["device_s"] * 100.0
