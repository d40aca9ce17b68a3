"""Share of the traced window in which no kernel, copy or set ran on the
device: 1 - (union of the device's intervals / window), in %."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
