"""The hand kernels' share of their roofline: the least time the card needs
for the work of theirs that ``portbench/work.py: kernel_bound_s`` counts
(the stage-1 sparse products and the assignment head's product, at the
real nodes and nonzeros of each traced call) over the device time of every
kernel under ``cgcnet_tpu_torch/csrc`` in the traced window, in %. Work of
the hand kernels left uncounted makes it a lower share, never a higher."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr.get("own_kernel_s", 0) <= 0 \
            or not rec.get("per_call_kernel_s"):
        return None
    return 100.0 * rec["per_call_kernel_s"] * rec["calls"] / tr["own_kernel_s"]
