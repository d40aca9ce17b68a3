"""Device kernels launched per step or request in the traced window: the
profiler's kernel events over the calls made."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["kernels"] or not rec.get("calls"):
        return None
    return tr["kernels"] / rec["calls"]
