"""capture_graph_s: the seconds of the program's warm-up and graph capture
(its ``txr.capture`` spans) in the cell's first call, which captures the
graphs the cell replays: the part of ``capture_s`` spent capturing, by the
program's own host-clock spans (``rtbench/spans.py``)."""
from rtbench import spans


def read(ctx):
    recs = spans.records()
    if not recs:
        return None
    first = recs[0]
    if not any(s.name == "txr.capture" for s in first["spans"]):
        return None
    return spans.ms(first, lambda n: n == "txr.capture") / 1e3
