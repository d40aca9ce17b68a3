"""Device ops: the BSR kernels (B1, B2), the fused assign head (B4) and its
training tail (B3 statistics, B5 backward), and the host-side NumPy graph
builders.

Importing this package registers the kernels that a traced program records
(``torch.export``) as custom ops, ``torch.ops.cgcnet_tpu_torch.*``: B1
``bsr_build_blocks``, B2 ``bsr_matmul``, B4 ``assign_head_softmax_pre`` and
B6 ``assign_head_softmax``. A program exported with them loads only after
this import."""

from cgcnet_tpu_torch.ops import assign_head, bsr  # noqa: F401  (custom ops)
