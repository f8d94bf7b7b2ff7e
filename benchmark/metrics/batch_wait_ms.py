"""Host ms in the program's ``han.next_batch`` spans (the wait on the
prefetch thread and the batch's upload) over the traced window's train
steps (``benchmark/spans.py``)."""

from benchmark import spans


def read(run: dict):
    rec = spans.reading(run)
    if rec is None or "han.next_batch" not in rec["spans"] or not run["train_steps"]:
        return None
    return spans.host_s(rec, "han.next_batch") / run["train_steps"] * 1e3
