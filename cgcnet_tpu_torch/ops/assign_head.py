"""Fused assign head of the stage-1 pooling block: B4 (eval and train
forward), B3 (BN batch statistics) and B5 (the tail's backward).

For each row of the raw conv3 lin output ``p`` (pre-normalize, pre-relu):

    rnorm  = 1 / max(||p||, 1e-12)                 over the whole row
    h      = (relu(p) * rnorm) rounded to p's dtype
    logits = x12 @ K12 + h @ K3f + const           (f32 accumulation)
    S      = softmax(logits) in f32, rows >= n_nodes exactly 0, in p's dtype

B4 returns (S [B, N, C], S^T [B, C, N]) with S^T a transposed view of S:
conv3's L2-normalize + relu, the BN-folded lin and the DiffPool assignment
softmax of the pooling block in one pass. In training the BN statistics of
h come from B3 (column sums of h and h^2 over real rows) and the tail's
backward to ``p`` is B5; ``AssignTailTrain`` strings B3, the [C]-sized BN
algebra and B4 together under one ``torch.autograd.Function``.

Replaces ``cgcnet_tpu/ops/pallas/assign_head.py``: ``_fwd_call_pre`` (B4),
``_stats_call`` (B3), ``_bwd_call`` (B5), ``assign_head_softmax_pre``'s and
``assign_tail_train``'s custom VJPs. Each kernel has a plain PyTorch version
with the same arguments; the wrapper uses it only for tensors on the CPU and
launches ``csrc/assign_head.cu`` or ``csrc/assign_tail.cu`` for CUDA tensors.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.ops import _cuda


def _prefix_mask(n_nodes: torch.Tensor, n: int) -> torch.Tensor:
    rows = torch.arange(n, device=n_nodes.device)
    return (rows[None, :] < n_nodes.long()[:, None]).float()


def _rnorm_h(pf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rnorm [..., 1], relu(p) * rnorm) of an f32 ``pf`` [..., C]: the L2
    row normalize (F.normalize, eps 1e-12) with relu folded in."""
    rnorm = 1.0 / torch.clamp_min(
        torch.sqrt(torch.sum(pf * pf, dim=-1, keepdim=True)), 1e-12
    )
    return rnorm, torch.clamp_min(pf, 0.0) * rnorm


def _check_rows(name: str, p: torch.Tensor, n_nodes: torch.Tensor) -> None:
    if p.dim() != 3 or n_nodes.shape != (p.shape[0],):
        raise ValueError(
            f"{name}: p {tuple(p.shape)} must be [B, N, C] and n_nodes "
            f"{tuple(n_nodes.shape)} [B]"
        )


# ---------------------------------------------------------------------------
# B4: fused head forward
# ---------------------------------------------------------------------------

def assign_head_softmax_pre_plain(
    x12: torch.Tensor,      # [B, N, F12] layers 1-2 concat
    p: torch.Tensor,        # [B, N, C]   conv3 raw lin output
    k12: torch.Tensor,      # [F12, C]
    k3f: torch.Tensor,      # [C, C]      BN-folded lin rows for conv3
    const: torch.Tensor,    # [C] f32
    n_nodes: torch.Tensor,  # i32[B]
) -> tuple[torch.Tensor, torch.Tensor]:
    dt = p.dtype
    _, h = _rnorm_h(p.float())
    h = h.to(dt).float()
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


# ---------------------------------------------------------------------------
# B3: BN batch statistics of h
# ---------------------------------------------------------------------------

# rows per block of the stats kernel; passed to it, which refuses any other
# value than its own kStatsRows (csrc/assign_tail.cu)
STATS_ROWS = 64


def l2relu_stats_plain(
    p: torch.Tensor,        # [B, N, C] conv3 raw lin output
    n_nodes: torch.Tensor,  # i32[B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum[C], sumsq[C]) f32 of h = rowmask * relu(l2norm(p)) with h
    rounded to p's dtype before summing (the unfused path stores h in the
    compute dtype before BN reads it)."""
    _, h = _rnorm_h(p.float())
    h = h * _prefix_mask(n_nodes, p.shape[1])[..., None]
    h = h.to(p.dtype).float()
    return torch.sum(h, dim=(0, 1)), torch.sum(h * h, dim=(0, 1))


def l2relu_stats(
    p: torch.Tensor, n_nodes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """B3. Same contract as :func:`l2relu_stats_plain`."""
    _check_rows("l2relu_stats", p, n_nodes)
    if p.device.type == "cpu":
        return l2relu_stats_plain(p, n_nodes)
    b, n, c = p.shape
    if p.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"l2relu_stats: unsupported dtype {p.dtype}")
    if n % STATS_ROWS:
        raise ValueError(f"l2relu_stats: N={n} must tile by {STATS_ROWS}")
    p = p.contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda("l2relu_stats", p, n_nodes)
    tiles = b * n // STATS_ROWS
    partial = torch.empty((tiles, 2, c), dtype=torch.float32, device=p.device)
    out = torch.empty((2, c), dtype=torch.float32, device=p.device)
    _cuda.launch(
        "cgc_l2relu_stats",
        p.data_ptr(), n_nodes.data_ptr(), partial.data_ptr(), out.data_ptr(),
        b, n, c, STATS_ROWS, _cuda.DTYPE_CODES[p.dtype], p.device.index,
        _cuda.stream_of(p),
    )
    l2relu_stats.launches += 1
    return out[0], out[1]


l2relu_stats.launches = 0


# ---------------------------------------------------------------------------
# B5: backward of normalize + relu + stats to p
# ---------------------------------------------------------------------------

def assign_tail_bwd_plain(
    p: torch.Tensor,        # [B, N, C] conv3 raw lin output
    dh: torch.Tensor,       # [B, N, C] softmax-path cotangent of h (row-masked)
    u: torch.Tensor,        # f32[C] cotangent of sum(h)
    w: torch.Tensor,        # f32[C] cotangent of sum(h^2)
    n_nodes: torch.Tensor,  # i32[B]
) -> torch.Tensor:
    """dp = rmask*(p>0)*rnorm*dh_tot - rnorm^2 * p * sum(dh_tot*hs), with
    hs = rmask*h and dh_tot = dh + rmask*(u + 2*hs*w); in p's dtype."""
    pf = p.float()
    rnorm, h = _rnorm_h(pf)
    rmask = _prefix_mask(n_nodes, p.shape[1])[..., None]
    hs = h * rmask
    dh_tot = dh.float() + rmask * (u.float() + 2.0 * hs * w.float())
    rd = torch.sum(dh_tot * hs, dim=-1, keepdim=True)
    dp = rmask * (pf > 0) * rnorm * dh_tot - rnorm * rnorm * pf * rd
    return dp.to(p.dtype)


def assign_tail_bwd(
    p: torch.Tensor,
    dh: torch.Tensor,
    u: torch.Tensor,
    w: torch.Tensor,
    n_nodes: torch.Tensor,
) -> torch.Tensor:
    """B5. Same contract as :func:`assign_tail_bwd_plain`."""
    _check_rows("assign_tail_bwd", p, n_nodes)
    c = p.shape[-1]
    if dh.shape != p.shape or u.shape != (c,) or w.shape != (c,):
        raise ValueError(
            f"assign_tail_bwd: p {tuple(p.shape)}, dh {tuple(dh.shape)}, "
            f"u {tuple(u.shape)}, w {tuple(w.shape)} disagree"
        )
    if p.device.type == "cpu":
        return assign_tail_bwd_plain(p, dh, u, w, n_nodes)
    dt = p.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"assign_tail_bwd: unsupported dtype {dt}")
    b, n, _ = p.shape
    p = p.contiguous()
    dh = dh.to(dt).contiguous()
    u = u.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda("assign_tail_bwd", p, dh, u, w, n_nodes)
    dp = torch.empty_like(p)
    _cuda.launch(
        "cgc_assign_tail_bwd",
        p.data_ptr(), dh.data_ptr(), u.data_ptr(), w.data_ptr(),
        n_nodes.data_ptr(), dp.data_ptr(), b, n, c, _cuda.DTYPE_CODES[dt],
        p.device.index, _cuda.stream_of(p),
    )
    assign_tail_bwd.launches += 1
    return dp


assign_tail_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd: eval-mode head (B4) and the training tail (B3 + B4, B5)
# ---------------------------------------------------------------------------

def _softmax_vjp(s: torch.Tensor, ds: torch.Tensor):
    """(dl in S's dtype, dl in f32) of the masked softmax: S carries the row
    mask, so dl is zero on padded rows."""
    sf = s.float()
    gf = ds.float()
    dl32 = sf * (gf - torch.sum(gf * sf, dim=-1, keepdim=True))
    return dl32.to(s.dtype), dl32


def _head_grads(x12, k12, dl, dl32):
    """(dx12, dk12, dconst) of logits = x12 @ k12 + ... + const."""
    dx12 = dl @ k12.to(dl.dtype).t()
    dk12 = torch.einsum("bnf,bnc->fc", x12.float(), dl.float()).to(k12.dtype)
    return dx12, dk12, torch.sum(dl32, dim=(0, 1))


class AssignHeadSoftmaxPre(torch.autograd.Function):
    """B4 with the backward of ``assign_head_softmax_pre``'s custom VJP
    (``_ahp_bwd``): the BN affine is already folded, so every cotangent is
    plain tensor algebra (no kernel). Returns S only; the caller takes
    ``S.transpose(1, 2)`` itself so autograd adds the S^T cotangent."""

    @staticmethod
    def forward(ctx, x12, p, k12, k3f, const, n_nodes):
        s, _ = assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes)
        ctx.save_for_backward(x12, p, k12, k3f, s)
        return s

    @staticmethod
    def backward(ctx, ds):
        x12, p, k12, k3f, s = ctx.saved_tensors
        dl, dl32 = _softmax_vjp(s, ds)
        dx12, dk12, dconst = _head_grads(x12, k12, dl, dl32)
        pf = p.float()
        rnorm, h32 = _rnorm_h(pf)
        h = h32.to(p.dtype)
        dk3f = torch.einsum("bnc,bnd->cd", h.float(), dl.float()).to(k3f.dtype)
        dh = (dl @ k3f.to(dl.dtype).t()).float()
        rd = torch.sum(dh * h32, dim=-1, keepdim=True)
        dp = (pf > 0) * rnorm * dh - rnorm * rnorm * pf * rd
        return dx12, dp.to(p.dtype), dk12, dk3f, dconst, None


def tail_algebra(ssum, ssq, k3, lin_bias, bn_scale, bn_bias, n, eps):
    """[C]-sized algebra between B3 and B4: single-pass BN moments (variance
    clamped at 0, divisor at least 1) -> folded affine -> folded lin kernel
    and bias. Returns (k3f, const, mean, var)."""
    n = torch.clamp_min(n, 1.0)
    mean = ssum / n
    var = torch.clamp_min(ssq / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps) * bn_scale
    shift = bn_bias - mean * inv
    k3f = inv[:, None] * k3
    const = shift @ k3 + lin_bias
    return k3f, const, mean, var


class AssignTailTrain(torch.autograd.Function):
    """Training-mode assign tail: L2-normalize + relu + BN batch statistics
    (B3) + BN-affine fold + folded lin + masked softmax (B4). Returns
    (S, batch mean, batch var); mean and var feed only the running-stat
    update and carry no gradient.

    Backward (``_atf_bwd``): the softmax VJP, the two large products
    (``dl @ k3f^T``, ``h^T dl``) in ``torch.matmul``, the [C]-sized algebra
    differentiated by autograd, and one B5 launch for ``dp``."""

    @staticmethod
    def forward(ctx, x12, p, k12, k3, lin_bias, bn_scale, bn_bias, n_nodes, n,
                eps):
        ssum, ssq = l2relu_stats(p, n_nodes)
        k3f, const, mean, var = tail_algebra(
            ssum, ssq, k3, lin_bias, bn_scale, bn_bias, n, eps
        )
        s, _ = assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes)
        ctx.save_for_backward(x12, p, k12, k3f, s, n_nodes, ssum, ssq, k3,
                              lin_bias, bn_scale, bn_bias, n)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return s, mean, var

    @staticmethod
    def backward(ctx, ds, _dmean, _dvar):
        (x12, p, k12, k3f, s, n_nodes, ssum, ssq, k3, lin_bias, bn_scale,
         bn_bias, n) = ctx.saved_tensors
        dl, dl32 = _softmax_vjp(s, ds)
        dx12, dk12, dconst = _head_grads(x12, k12, dl, dl32)
        dh = dl @ k3f.to(dl.dtype).t()
        # h materialized once, row-masked and rounded, for the folded-kernel
        # gradient only
        _, h32 = _rnorm_h(p.float())
        h = (h32 * _prefix_mask(n_nodes, p.shape[1])[..., None]).to(p.dtype)
        dk3f = torch.einsum("bnc,bnd->cd", h.float(), dl.float())
        leaves = [t.detach().requires_grad_(True)
                  for t in (ssum, ssq, k3, lin_bias, bn_scale, bn_bias)]
        with torch.enable_grad():
            k3f_, const_, _, _ = tail_algebra(*leaves, n, ctx.eps)
            dssum, dssq, dk3, dlin_bias, dbn_scale, dbn_bias = torch.autograd.grad(
                (k3f_, const_), leaves, (dk3f, dconst)
            )
        dp = assign_tail_bwd(p, dh, dssum, dssq, n_nodes)
        return (dx12, dp, dk12, dk3, dlin_bias, dbn_scale, dbn_bias,
                None, None, None)
