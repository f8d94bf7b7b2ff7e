"""Host seconds in the program's ``han.save`` spans (the best epoch's
snapshot and the checkpoint's write) over the traced window, in %: 0 where
the program's spans show no save in the window (``benchmark/spans.py``)."""

from benchmark import spans


def read(run: dict):
    rec = spans.reading(run)
    if rec is None:
        return None
    return spans.host_s(rec, "han.save") / rec["window_s"] * 100.0
