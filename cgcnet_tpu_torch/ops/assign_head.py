"""Fused assign head of the stage-1 pooling block (B4, "pre" mode).

For each row of the raw conv3 lin output ``p`` (pre-normalize, pre-relu):

    rnorm  = 1 / max(||p||, 1e-12)                 over the whole row
    h      = (relu(p) * rnorm) rounded to p's dtype
    logits = x12 @ K12 + h @ K3f + const           (f32 accumulation)
    S      = softmax(logits) in f32, rows >= n_nodes exactly 0, in p's dtype

and returns (S [B, N, C], S^T [B, C, N]) with S^T a transposed view of S.
This is conv3's L2-normalize + relu, the BN-folded lin and the DiffPool
assignment softmax of the pooling block in one pass (eval mode).

Replaces ``cgcnet_tpu/ops/pallas/assign_head.py: _fwd_call_pre``. The plain
PyTorch version takes the same arguments; the wrapper uses it only for
tensors on the CPU and launches ``csrc/assign_head.cu`` for CUDA tensors.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.ops import _cuda


def _prefix_mask(n_nodes: torch.Tensor, n: int) -> torch.Tensor:
    rows = torch.arange(n, device=n_nodes.device)
    return (rows[None, :] < n_nodes.long()[:, None]).float()


def assign_head_softmax_pre_plain(
    x12: torch.Tensor,      # [B, N, F12] layers 1-2 concat
    p: torch.Tensor,        # [B, N, C]   conv3 raw lin output
    k12: torch.Tensor,      # [F12, C]
    k3f: torch.Tensor,      # [C, C]      BN-folded lin rows for conv3
    const: torch.Tensor,    # [C] f32
    n_nodes: torch.Tensor,  # i32[B]
) -> tuple[torch.Tensor, torch.Tensor]:
    dt = p.dtype
    pf = p.float()
    rnorm = 1.0 / torch.clamp_min(
        torch.sqrt(torch.sum(pf * pf, dim=-1, keepdim=True)), 1e-12
    )
    h = (torch.clamp_min(pf, 0.0) * rnorm).to(dt).float()
    logits = (
        x12.float() @ k12.to(dt).float()
        + h @ k3f.to(dt).float()
        + const.float()
    )
    s = torch.softmax(logits, dim=-1)
    s = (s * _prefix_mask(n_nodes, p.shape[1])[..., None]).to(dt)
    return s, s.transpose(1, 2)


def assign_head_softmax_pre(
    x12: torch.Tensor,
    p: torch.Tensor,
    k12: torch.Tensor,
    k3f: torch.Tensor,
    const: torch.Tensor,
    n_nodes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B4. Same contract as :func:`assign_head_softmax_pre_plain`."""
    b, n, c = p.shape
    f12 = x12.shape[-1]
    if (
        x12.shape[:2] != (b, n) or k12.shape != (f12, c)
        or k3f.shape != (c, c) or const.shape != (c,) or n_nodes.shape != (b,)
    ):
        raise ValueError(
            "assign_head_softmax_pre: shapes disagree: x12 "
            f"{tuple(x12.shape)}, p {tuple(p.shape)}, k12 {tuple(k12.shape)}, "
            f"k3f {tuple(k3f.shape)}, const {tuple(const.shape)}, "
            f"n_nodes {tuple(n_nodes.shape)}"
        )
    if x12.dtype != p.dtype:
        raise ValueError(
            f"assign_head_softmax_pre: x12 {x12.dtype} != p {p.dtype}"
        )
    if p.device.type == "cpu":
        return assign_head_softmax_pre_plain(x12, p, k12, k3f, const, n_nodes)
    dt = p.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"assign_head_softmax_pre: unsupported dtype {dt}")
    if n % 128:
        raise ValueError(f"assign_head_softmax_pre: N={n} must tile by 128")
    x12, p = x12.contiguous(), p.contiguous()
    k12 = k12.to(dt).contiguous()
    k3f = k3f.to(dt).contiguous()
    const = const.to(torch.float32).contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda("assign_head_softmax_pre", x12, p, k12, k3f, const, n_nodes)
    s = torch.empty((b, n, c), dtype=dt, device=p.device)
    rnorm = torch.empty((b * n,), dtype=torch.float32, device=p.device)
    # f32 logits: S itself holds them in f32 (normalized in place), bf16
    # needs an f32 scratch so the softmax sees unrounded logits
    logits = s if dt == torch.float32 else torch.empty(
        (b, n, c), dtype=torch.float32, device=p.device
    )
    _cuda.launch(
        "cgc_assign_head_pre",
        x12.data_ptr(), p.data_ptr(), k12.data_ptr(), k3f.data_ptr(),
        const.data_ptr(), n_nodes.data_ptr(), rnorm.data_ptr(),
        logits.data_ptr(), s.data_ptr(), b, n, f12, c, _cuda.DTYPE_CODES[dt],
        p.device.index, _cuda.stream_of(p),
    )
    assign_head_softmax_pre.launches += 1
    return s, s.transpose(1, 2)


assign_head_softmax_pre.launches = 0
