"""Host ms in the program's dispatch spans, ``han.train_step`` and
``han.eval_step`` (each the input copies and the graph replay, or the
eager or capturing call), over the traced window's train steps
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run: dict):
    rec = spans.reading(run)
    if rec is None or "han.train_step" not in rec["spans"] or not run["train_steps"]:
        return None
    return spans.host_s(rec, "han.train_step", "han.eval_step") / run["train_steps"] * 1e3
