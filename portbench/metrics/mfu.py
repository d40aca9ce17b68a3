"""The whole step's share of the card's published peak for the
configuration's compute type: the operations the step needs
(``portbench/work.py``, real nodes and edges, no recomputation) over the
traced window's time per call, in %."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or not rec.get("per_call_flops"):
        return None
    per_call_s = rec["wall_s"] / rec["calls"]
    return 100.0 * rec["per_call_flops"] / per_call_s / rec["peak_flops"]
