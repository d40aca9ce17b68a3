"""Operations the model needs, counted from the shapes of real inputs, and
the card's published peaks.

``graph_flops`` counts the multiply-adds (2 operations each) of every
product CGC-Net's forward needs for one graph of ``n`` real nodes and
``edges`` real neighbour slots other than the node itself: the sparse
aggregations over the n + edges nonzeros of the stage-1 adjacency, the
layers' linear maps, the LSTM jumping knowledge, the DiffPool contractions
and the dense pooled stages (1140 and 114 clusters). Padding rows, block
slots, lane padding and recomputation are not counted; element-wise work
(normalizations, softmax, BatchNorm) is not counted. Training counts the
backward as twice the forward. The bound arithmetic (``bound_s``) is
``chip_smoke.py``'s: the larger of bytes at the HBM rate and operations at
the type's peak.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12,        # f32 outside the tensor cores
                  "bfloat16": 989e12}      # dense bf16 tensor cores


def peak_flops(cfg) -> float:
    return PEAK_OPS_PER_S[cfg.model.compute_dtype]


def bound_s(bytes_: float, ops: float, dtype: str) -> float:
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def _jk(rows: int, h: int) -> int:
    lh = 3 * h // 2
    per_dir = 3 * 2 * rows * h * 4 * lh + 2 * 2 * rows * lh * 4 * lh
    return 2 * per_dir + 3 * 2 * rows * 2 * lh


def _sage_pair(rows: int, nnz: int, fin: int, h: int, out3: int,
               assign: int) -> int:
    """An (embed, pool) pair of 3-layer SAGE blocks sharing each layer's
    aggregation, the pool block's lin to ``assign`` logits included."""
    agg = 2 * nnz * fin + 2 * 2 * nnz * 2 * h
    lins = (2 * rows * fin * 2 * h + 2 * 2 * rows * h * h
            + 2 * rows * h * h + 2 * rows * h * out3)
    return agg + lins + 2 * rows * (2 * h + out3) * assign


def graph_flops(n: int, edges: int, m) -> int:
    """Forward operations of one graph (``m``: the model configuration)."""
    h, f0 = m.hidden_dim, m.input_dim
    c1, c2 = m.assign_dims
    nnz = n + edges
    fl = _sage_pair(n, nnz, f0, h, c1, c1) + _jk(n, h)
    fl += 2 * n * c1 * h + 2 * nnz * c1 + 2 * n * c1 * c1
    fl += _sage_pair(c1, c1 * c1, h, h, c2, c2) + _jk(c1, h)
    fl += 2 * c1 * c2 * h + 2 * c1 * c1 * c2 + 2 * c1 * c2 * c2
    fl += 3 * (2 * c2 * c2 * h + 2 * c2 * h * h) + _jk(c2, h)
    hid = m.pred_hidden_dims[0]
    fl += 2 * (3 * h * hid + hid * m.num_classes)
    return fl


def batch_sizes(graph) -> list:
    """[(real nodes, real ELL slots, the node itself included)] of each
    graph of a batch (a ``CellGraph``)."""
    n = graph.n_nodes.tolist()
    slots = graph.nbr_mask.sum(dim=(1, 2)).tolist()
    return [(int(a), int(b)) for a, b in zip(n, slots)]


def call_flops(cfg, sizes, train: bool) -> int:
    """Operations of one call over graphs of ``sizes`` [(real nodes, real
    ELL slots)]."""
    fwd = sum(graph_flops(n, k - n, cfg.model) for n, k in sizes)
    return 3 * fwd if train else fwd


ACT_BYTES = {"float32": 4, "bfloat16": 2}


def sparse_widths(m, train: bool) -> list:
    """Widths of the stage-1 sparse products a call needs: x (once for
    both blocks), the two blocks' layer-2 and layer-3 inputs side by side,
    A @ S; training adds the transposed products of the gradients (x needs
    none)."""
    h, c1 = m.hidden_dim, m.assign_dims[0]
    fwd = [m.input_dim, 2 * h, 2 * h, c1]
    return fwd + ([2 * h, 2 * h, c1] if train else [])


def kernel_bound_s(cfg, sizes, train: bool) -> float:
    """The least time the card needs for the hand kernels' share of one
    call over graphs of ``sizes`` [(real nodes, real ELL slots)]: each
    stage-1 sparse product (2 operations per nonzero and column; x read
    and the product written once, a byte per nonzero of the operator) and
    the assignment head's forward product (2 operations per row, input
    column and cluster; its row inputs read and S written once), each at
    the larger of its bytes and its operations. What the hand kernels do
    besides (building the blocks, the statistics, the tail's backward) is
    not counted, so the share this bounds is a lower one."""
    m, dt = cfg.model, cfg.model.compute_dtype
    s = ACT_BYTES[dt]
    rows = sum(n for n, _ in sizes)
    nnz = sum(k for _, k in sizes)
    h, c1 = m.hidden_dim, m.assign_dims[0]
    t = sum(bound_s(2 * rows * f * s + nnz, 2 * nnz * f, dt)
            for f in sparse_widths(m, train))
    return t + bound_s(rows * (2 * h + c1) * s,
                       2 * rows * (2 * h + c1) * c1, dt)


def traced_work(cfg, calls: list, train: bool) -> dict:
    """What the per-layer readers need of the traced calls, each given by
    its graphs' sizes: the type's peak, and the mean operations and
    hand-kernel bound seconds a call."""
    k = len(calls)
    return {"peak_flops": peak_flops(cfg),
            "per_call_flops": sum(call_flops(cfg, c, train)
                                  for c in calls) / k,
            "per_call_kernel_s": sum(kernel_bound_s(cfg, c, train)
                                     for c in calls) / k}
