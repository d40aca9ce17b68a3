"""Device ops: the BSR kernels (B1, B2), the fused assign head (B4) and its
training tail (B3 statistics, B5 backward), and the host-side NumPy graph
builders.

Importing this package registers the kernels that a traced program records
(``torch.export``) as custom ops, ``torch.ops.cgcnet_tpu_torch.*``: B1
``bsr_build_blocks``, B2 ``bsr_matmul``, B4 ``assign_head_softmax_pre`` and
B6 ``assign_head_softmax``. A program exported with them loads only after
this import.

:func:`kernel_wrappers` names every kernel's wrapper; each wrapper adds one
to its ``launches`` where it launches its kernel, and nowhere else."""

from cgcnet_tpu_torch.ops import assign_head, bsr  # noqa: F401  (custom ops)

KERNELS = {"B1": (bsr, "bsr_build_blocks"), "B2": (bsr, "bsr_matmul"),
           "B3": (assign_head, "l2relu_stats"),
           "B4": (assign_head, "assign_head_softmax_pre"),
           "B5": (assign_head, "assign_tail_bwd"),
           "B6": (assign_head, "assign_head_softmax"),
           "B7": (bsr, "bsr_gather_sum"), "B8": (bsr, "bsr_matmul_banded"),
           "B9a": (assign_head, "assign_head_softmax_pre_lin"),
           "B9b": (assign_head, "l2relu_stats_lin")}


def kernel_wrappers() -> dict:
    """Kernel id -> its wrapper, looked up by module name at each call (a
    shim put in a wrapper's place counts in its own ``launches``)."""
    return {k: getattr(mod, name) for k, (mod, name) in KERNELS.items()}
