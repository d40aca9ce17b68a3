"""Fused assign head of the stage-1 pooling block: B4 (eval and train
forward), B3 (BN batch statistics), B5 (the tail's backward), B6 (the
head without the normalize step), and B9a / B9b (B4 and B3 with conv3's
lin inside, the whole-slide capacity path).

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

B6 is the head of every other folded tail (GIN, GAT, a non-relu
activation): its second operand is conv3's activation ``h3a`` itself, with
bn3's affine already folded into K3f and const, so

    S = softmax(x12 @ K12 + h3a @ K3f + const), rows >= n_nodes exactly 0.

The whole-slide path adds: B4 with ``c_out`` (S written lane-padded, pad
columns exact zeros) under ``AssignTailTrainPsum`` (the training tail with
the statistics summed over the graph axis); and, for the capacity path,
B9a and B9b, which take conv3's lin input x3 [B, N, F3] and its kernel and
bias instead of p (p = round(x3 @ kc3) + b3 formed inside the kernels, never
stored), under ``AssignTailTrainChunkedLin``, whose backward recomputes S
and p chunk by chunk in two phases.

In bf16 the heads' product (B4, B6, B9a) runs on the tensor cores over
one zero-padded copy of [K12 ; K3f] (``pad_head_weights``, made per call)
and, for B9a and B9b, a transposed padded kc3 (``pad_lin_kernel``) from
which the same device routines form p and its row norm for B9a's product
and B9b's statistics; in f32 on the SIMT kernels.
``l2relu_stats_reference`` / ``l2relu_stats_lin_reference`` are the exact
(f64) yardsticks of B3's and B9b's statistics for the card's hold, and
``STATS_TOL``, ``stats_distance`` and the witnesses' routes its measure; no
path of the package calls them.

Replaces ``cgcnet_tpu/ops/pallas/assign_head.py``: ``_fwd_call_pre`` (B4),
``_stats_call`` (B3), ``_bwd_call`` (B5), ``_fwd_call`` (B6),
``_fwd_call_pre_lin`` (B9a), ``_stats_call_lin`` (B9b),
``assign_head_softmax_pre``'s, ``assign_tail_train``'s,
``assign_tail_train_psum``'s, ``assign_tail_train_chunked_lin``'s and
``assign_head_softmax``'s custom VJPs, ``pick_chunk`` and ``_chunk_plan``. Each kernel has a plain PyTorch version
with the same arguments; the wrapper uses it only for tensors on the CPU and
launches ``csrc/assign_head.cu`` or ``csrc/assign_tail.cu`` for CUDA tensors.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from cgcnet_tpu_torch.ops import _cuda
from cgcnet_tpu_torch.parallel import mega_graph
from cgcnet_tpu_torch.parallel.mesh import ONE

TILE = 128
# the bf16 product's tiling (csrc/assign_head.cu gemm_tc_kernel): K in
# stages of HEAD_K rows, output columns in tiles of HEAD_N, B9a's x3 padded
# to F3_PAD columns (two k-steps of its mma.sync). The C entries take the
# padded copies' shapes and refuse any but their own tiling's.
HEAD_K, HEAD_N, F3_PAD = 64, 192, 32


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pad_head_weights(k12: torch.Tensor, k3f: torch.Tensor) -> torch.Tensor:
    """[K12 ; K3f] as the bf16 product's weight operand: one zero-padded
    copy of [round_up(F12, 64) + round_up(C, 64), round_up(C, 192)], K12 in
    rows [0, F12), K3f in rows [round_up(F12, 64), + C), columns [0, C) —
    every row 16-byte aligned and every tile of the kernel in bounds."""
    f12, c = k12.shape
    k12p = _round_up(f12, HEAD_K)
    w = torch.zeros((k12p + _round_up(c, HEAD_K), _round_up(c, HEAD_N)),
                    dtype=torch.bfloat16, device=k12.device)
    w[:f12, :c] = k12
    w[k12p:k12p + c, :c] = k3f
    return w


def pad_lin_kernel(kc3: torch.Tensor) -> torch.Tensor:
    """kc3 [F3, C] transposed into a zero-padded [round_up(C, 64), F3_PAD]
    copy: B9a's operand for the product that forms p on the tensor
    cores (rows past C and columns past F3 are zeros)."""
    f3, c = kc3.shape
    if f3 > F3_PAD:
        raise ValueError(f"the bf16 B9a product takes F3 <= {F3_PAD}, got "
                         f"{f3}")
    t = torch.zeros((_round_up(c, HEAD_K), F3_PAD), dtype=torch.bfloat16,
                    device=kc3.device)
    t[:c, :f3] = kc3.t()
    return t


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _shape2(t: torch.Tensor | None) -> tuple[int, int]:
    """A padded copy's (rows, columns) for the entry's check; (0, 0) for
    none (f32)."""
    return (0, 0) if t is None else tuple(t.shape)


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
    c_out=None,             # S width >= C (exact-zero pad columns)
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
    if c_out is not None and c_out != s.shape[-1]:
        s = torch.nn.functional.pad(s, (0, c_out - s.shape[-1]))
    return s, s.transpose(1, 2)


def _check_head(name, x12, p, k12, k3f, const, n_nodes) -> None:
    b, n, c = p.shape
    f12 = x12.shape[-1]
    if (
        x12.shape[:2] != (b, n) or k12.shape != (f12, c)
        or k3f.shape != (c, c) or const.shape != (c,) or n_nodes.shape != (b,)
    ):
        raise ValueError(
            f"{name}: shapes disagree: x12 {tuple(x12.shape)}, p/h3a "
            f"{tuple(p.shape)}, k12 {tuple(k12.shape)}, k3f "
            f"{tuple(k3f.shape)}, const {tuple(const.shape)}, n_nodes "
            f"{tuple(n_nodes.shape)}"
        )
    if x12.dtype != p.dtype:
        raise ValueError(f"{name}: x12 {x12.dtype} != p/h3a {p.dtype}")


def _check_c_out(name: str, c: int, c_out) -> int:
    co = c if c_out is None else int(c_out)
    if co < c:
        raise ValueError(f"{name}: c_out {co} < C {c}")
    return co


def _launch_head(pre: bool, x12, p, k12, k3f, const, n_nodes, c_out=None):
    """S of the B4 (``pre``: p normalized on load) or B6 kernel on CUDA
    tensors, ``c_out`` columns wide."""
    entry = "cgc_assign_head_pre" if pre else "cgc_assign_head"
    b, n, c = p.shape
    co = _check_c_out(entry, c, c_out)
    dt = p.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"{entry}: unsupported dtype {dt}")
    if n % 128:
        raise ValueError(f"{entry}: N={n} must tile by 128")
    x12, p = x12.contiguous(), p.contiguous()
    bf = dt == torch.bfloat16
    # bf16 reads only the padded copy (made below, cast as it is copied)
    wdt = k12.dtype if bf else dt
    k12, k3f = k12.to(wdt).contiguous(), k3f.to(wdt).contiguous()
    const = const.to(torch.float32).contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda(entry, x12, p, k12, k3f, const, n_nodes)
    s = torch.empty((b, n, co), dtype=dt, device=p.device)
    # f32 logits: S itself holds them in f32 (normalized in place) unless
    # it is padded; bf16 needs an f32 scratch so the softmax sees unrounded
    # logits
    logits = s if (dt == torch.float32 and co == c) else torch.empty(
        (b, n, c), dtype=torch.float32, device=p.device
    )
    # B4's per-row 1/||p|| scratch, launched first so the card works while
    # the weights are padded; B6 reads none and is given a null pointer
    rnorm = None
    if pre:
        rnorm = torch.empty((b * n,), dtype=torch.float32, device=p.device)
        _cuda.launch(
            "cgc_assign_head_rnorm", p.data_ptr(), None, None, None, None,
            n_nodes.data_ptr(), rnorm.data_ptr(), b, n, 0, c, 0, 0,
            _cuda.DTYPE_CODES[dt], p.device.index, _cuda.stream_of(p),
        )
    # bf16 runs on the tensor cores, which read only the padded weight copy
    # (the entry checks its shape), f32 only k12 and k3f
    wpad = pad_head_weights(k12, k3f) if bf else None
    _cuda.launch(
        entry,
        x12.data_ptr(), p.data_ptr(), _ptr(None if bf else k12),
        _ptr(None if bf else k3f), _ptr(wpad),
        const.data_ptr(), n_nodes.data_ptr(), _ptr(rnorm),
        logits.data_ptr(), s.data_ptr(), b, n, x12.shape[-1], c, co,
        *_shape2(wpad), _cuda.DTYPE_CODES[dt], p.device.index,
        _cuda.stream_of(p),
    )
    return s


def assign_head_softmax_pre(
    x12: torch.Tensor,
    p: torch.Tensor,
    k12: torch.Tensor,
    k3f: torch.Tensor,
    const: torch.Tensor,
    n_nodes: torch.Tensor,
    c_out=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B4. Same contract as :func:`assign_head_softmax_pre_plain`."""
    _check_head("assign_head_softmax_pre", x12, p, k12, k3f, const, n_nodes)
    _check_c_out("assign_head_softmax_pre", p.shape[-1], c_out)
    if p.device.type == "cpu":
        return assign_head_softmax_pre_plain(x12, p, k12, k3f, const, n_nodes,
                                             c_out)
    if torch.compiler.is_compiling():
        s = assign_head_softmax_pre_op(x12, p, k12, k3f, const, n_nodes, c_out)
        return s, s.transpose(1, 2)
    s = _launch_head(True, x12, p, k12, k3f, const, n_nodes, c_out)
    assign_head_softmax_pre.launches += 1
    _B4_VARIANTS[head_product(p.dtype)] += 1
    return s, s.transpose(1, 2)


assign_head_softmax_pre.launches = 0
# module objects, not looked up through the wrappers' names: a shim in a
# wrapper's place records nothing
assign_head_softmax_pre.variants = _B4_VARIANTS = Counter()


def head_product(dtype: torch.dtype) -> str:
    """The kernel of B4's, B6's and B9a's product for activations of
    ``dtype`` (``csrc/assign_head.cu``): the tensor cores in bf16, the CUDA
    cores in f32. Each of the three wrappers counts its launches by it in
    ``variants``."""
    return "gemm_tc_kernel" if dtype == torch.bfloat16 else "gemm_kernel"


@torch.library.custom_op("cgcnet_tpu_torch::assign_head_softmax_pre",
                         mutates_args=())
def assign_head_softmax_pre_op(
    x12: torch.Tensor, p: torch.Tensor, k12: torch.Tensor, k3f: torch.Tensor,
    const: torch.Tensor, n_nodes: torch.Tensor, c_out: Optional[int] = None,
) -> torch.Tensor:
    """B4 as ``torch.ops.cgcnet_tpu_torch.assign_head_softmax_pre``: what a
    traced program (``torch.export``) records where the wrapper meets a
    CUDA tensor; running it calls the wrapper, which launches the kernel.
    Returns S only (an op's outputs alias nothing); S^T is its transpose."""
    return assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes, c_out)[0]


@assign_head_softmax_pre_op.register_fake
def _(x12, p, k12, k3f, const, n_nodes, c_out=None):
    b, n, c = p.shape
    return p.new_empty((b, n, c if c_out is None else c_out))


# ---------------------------------------------------------------------------
# B6: fused head without the normalize step
# ---------------------------------------------------------------------------

def assign_head_softmax_plain(
    x12: torch.Tensor,      # [B, N, F12] layers 1-2 concat
    h3a: torch.Tensor,      # [B, N, C]   conv3 activation (pre-BN)
    k12: torch.Tensor,      # [F12, C]
    k3f: torch.Tensor,      # [C, C]      BN-folded lin rows for conv3
    const: torch.Tensor,    # [C] f32
    n_nodes: torch.Tensor,  # i32[B]
) -> torch.Tensor:
    """S [B, N, C] = softmax(x12 @ K12 + h3a @ K3f + const) in f32 (the
    kernels cast to h3a's dtype, f32 accumulation), rows >= n_nodes exactly
    0, in h3a's dtype. S^T is ``S.transpose(1, 2)``."""
    dt = h3a.dtype
    logits = (
        x12.float() @ k12.to(dt).float()
        + h3a.float() @ k3f.to(dt).float()
        + const.float()
    )
    s = torch.softmax(logits, dim=-1)
    return (s * _prefix_mask(n_nodes, h3a.shape[1])[..., None]).to(dt)


def assign_head_softmax(
    x12: torch.Tensor,
    h3a: torch.Tensor,
    k12: torch.Tensor,
    k3f: torch.Tensor,
    const: torch.Tensor,
    n_nodes: torch.Tensor,
) -> torch.Tensor:
    """B6. Same contract as :func:`assign_head_softmax_plain`; launches
    ``csrc/assign_head.cu`` (without B4's normalize step) for CUDA
    tensors."""
    _check_head("assign_head_softmax", x12, h3a, k12, k3f, const, n_nodes)
    if h3a.device.type == "cpu":
        return assign_head_softmax_plain(x12, h3a, k12, k3f, const, n_nodes)
    if torch.compiler.is_compiling():
        return assign_head_softmax_op(x12, h3a, k12, k3f, const, n_nodes)
    s = _launch_head(False, x12, h3a, k12, k3f, const, n_nodes)
    assign_head_softmax.launches += 1
    _B6_VARIANTS[head_product(h3a.dtype)] += 1
    return s


assign_head_softmax.launches = 0
assign_head_softmax.variants = _B6_VARIANTS = Counter()


@torch.library.custom_op("cgcnet_tpu_torch::assign_head_softmax",
                         mutates_args=())
def assign_head_softmax_op(
    x12: torch.Tensor, h3a: torch.Tensor, k12: torch.Tensor,
    k3f: torch.Tensor, const: torch.Tensor, n_nodes: torch.Tensor,
) -> torch.Tensor:
    """B6 as ``torch.ops.cgcnet_tpu_torch.assign_head_softmax`` (see
    :func:`assign_head_softmax_pre_op`)."""
    return assign_head_softmax(x12, h3a, k12, k3f, const, n_nodes)


@assign_head_softmax_op.register_fake
def _(x12, h3a, k12, k3f, const, n_nodes):
    return h3a.new_empty(h3a.shape)


# ---------------------------------------------------------------------------
# B3: BN batch statistics of h
# ---------------------------------------------------------------------------

# the most blocks of B3's grid (csrc/assign_tail.cu kStatsBlocks), each
# writing one [2, C] partial: the scratch B3 and f32 B9b are given, which
# their entry refuses if it holds fewer than the grid's blocks
STATS_BLOCKS = 256
# rows per block of bf16 B9b (csrc/assign_tail.cu kLinRows): one partial
# each, N a multiple of it
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
    p = p.contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda("l2relu_stats", p, n_nodes)
    partial = torch.empty((STATS_BLOCKS, 2, c), dtype=torch.float32,
                          device=p.device)
    out = torch.empty((2, c), dtype=torch.float32, device=p.device)
    _cuda.launch(
        "cgc_l2relu_stats",
        p.data_ptr(), n_nodes.data_ptr(), partial.data_ptr(), out.data_ptr(),
        None, b, n, c, STATS_BLOCKS, _cuda.DTYPE_CODES[p.dtype],
        p.device.index, _cuda.stream_of(p),
    )
    l2relu_stats.launches += 1
    return out[0], out[1]


l2relu_stats.launches = 0


def l2relu_stats_reference(
    p: torch.Tensor,        # [B, N, C] conv3 raw lin output
    n_nodes: torch.Tensor,  # i32[B]
    rnorm=None,             # [B, N, 1] f32 in place of the plain row norm
    round_h: bool = True,   # False: h summed without its rounding to T
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum[C], sumsq[C]) in f64 of the h that :func:`l2relu_stats_plain`
    sums — rnorm in f32 as it forms it, h = round_T(relu(p) * rnorm) on real
    rows — added in f64, so exact but for f64 rounding: the yardstick the
    card holds B3's and B9b's f32 sums against (``chip_smoke.py``'s
    statistics hold). ``rnorm`` and ``round_h`` make the hold's witnesses
    (a right computation by another route, one a rounding step off). No
    path of the package calls it."""
    pf = p.float()
    if rnorm is None:
        rnorm, _ = _rnorm_h(pf)
    h = torch.clamp_min(pf, 0.0) * rnorm
    h = h * _prefix_mask(n_nodes, p.shape[1])[..., None]
    if round_h:
        h = h.to(p.dtype)
    h = h.double()
    return torch.sum(h, dim=(0, 1)), torch.sum(h * h, dim=(0, 1))


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
# autograd: the heads (B4, B6) and the training tail (B3 + B4, B5)
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


class AssignHeadSoftmax(torch.autograd.Function):
    """B6 with the backward of ``assign_head_softmax``'s custom VJP
    (``_ah_bwd``) in plain tensor algebra. Returns S only; the caller takes
    ``S.transpose(1, 2)`` itself so autograd adds the S^T cotangent. bn3's
    batch moments reach this head through k3f and const, so autograd carries
    their gradient back to h3a."""

    @staticmethod
    def forward(ctx, x12, h3a, k12, k3f, const, n_nodes):
        s = assign_head_softmax(x12, h3a, k12, k3f, const, n_nodes)
        ctx.save_for_backward(x12, h3a, k12, k3f, s)
        return s

    @staticmethod
    def backward(ctx, ds):
        x12, h3a, k12, k3f, s = ctx.saved_tensors
        dl, dl32 = _softmax_vjp(s, ds)
        dx12, dk12, dconst = _head_grads(x12, k12, dl, dl32)
        dh3a = dl @ k3f.to(dl.dtype).t()
        dk3f = torch.einsum("bnc,bnd->cd", h3a.float(), dl.float()).to(k3f.dtype)
        return dx12, dh3a, dk12, dk3f, dconst, None


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


def _alg_grads(saved, n, eps, dk3f, dconst, dk3f_g, dconst_g):
    """Backward of :func:`tail_algebra` with the routing of the JAX
    package's ``_atfp_bwd``: the statistics' cotangents (which feed the
    row-sharded dp) come from the GLOBAL (psum'd) dk3f/dconst, the
    parameters' cotangents from this shard's own contributions (the
    parameters are replicated, and their gradients are summed across
    shards after the backward: ``parallel/mega_train.reduce_grads``).
    Returns (dssum, dssq, dk3, dlin_bias,
    dbn_scale, dbn_bias)."""
    leaves = [t.detach().requires_grad_(True) for t in saved]
    with torch.enable_grad():
        k3f_, const_, _, _ = tail_algebra(*leaves, n, eps)
        dssum, dssq = torch.autograd.grad(
            (k3f_, const_), leaves[:2], (dk3f_g, dconst_g), retain_graph=True
        )
        dk3, dlin_bias, dbn_scale, dbn_bias = torch.autograd.grad(
            (k3f_, const_), leaves[2:], (dk3f, dconst)
        )
    return dssum, dssq, dk3, dlin_bias, dbn_scale, dbn_bias


class AssignTailTrainPsum(torch.autograd.Function):
    """``AssignTailTrain`` with the BN statistics summed over the graph axis
    between B3 and B4 (the slide path's SyncBatchNorm) and S emitted
    ``c_out`` columns wide (exact-zero pad columns, so B8 reads a
    lane-aligned S). ``n`` is the global real-row count, ``axis`` the
    graph axis. Returns (S, batch mean, batch var). The backward
    (``_atfp_bwd``) runs the N-sized chains at the padded width against
    zero-padded kernels and trims the [C]-sized gradients."""

    @staticmethod
    def forward(ctx, x12, p, k12, k3, lin_bias, bn_scale, bn_bias, n_nodes,
                n, eps, c_out, axis):
        ssum, ssq = l2relu_stats(p, n_nodes)
        ssum, ssq = mega_graph.psum(ssum, axis), mega_graph.psum(ssq, axis)
        k3f, const, mean, var = tail_algebra(
            ssum, ssq, k3, lin_bias, bn_scale, bn_bias, n, eps
        )
        s, _ = assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes,
                                       c_out)
        ctx.save_for_backward(x12, p, k12, k3f, s, n_nodes, ssum, ssq, k3,
                              lin_bias, bn_scale, bn_bias, n)
        ctx.eps, ctx.axis = eps, axis
        ctx.mark_non_differentiable(mean, var)
        return s, mean, var

    @staticmethod
    def backward(ctx, ds, _dmean, _dvar):
        (x12, p, k12, k3f, s, n_nodes, ssum, ssq, k3, lin_bias, bn_scale,
         bn_bias, n) = ctx.saved_tensors
        c = k3f.shape[0]
        pad = s.shape[-1] - c
        dl, dl32 = _softmax_vjp(s, ds)
        pad_c = lambda k: torch.nn.functional.pad(k, (0, pad)) if pad else k
        dx12 = dl @ pad_c(k12).to(dl.dtype).t()
        dk12 = torch.einsum(
            "bnf,bnc->fc", x12.float(), dl.float()
        )[:, :c].to(k12.dtype)
        dconst = torch.sum(dl32, dim=(0, 1))[:c]
        dh = dl @ pad_c(k3f).to(dl.dtype).t()
        _, h32 = _rnorm_h(p.float())
        h = (h32 * _prefix_mask(n_nodes, p.shape[1])[..., None]).to(p.dtype)
        dk3f = torch.einsum("bnc,bnd->cd", h.float(), dl.float())[:, :c]
        dssum, dssq, dk3, dlin_bias, dbn_scale, dbn_bias = _alg_grads(
            (ssum, ssq, k3, lin_bias, bn_scale, bn_bias), n, ctx.eps,
            dk3f, dconst, mega_graph.psum(dk3f, ctx.axis),
            mega_graph.psum(dconst, ctx.axis),
        )
        dp = assign_tail_bwd(p, dh, dssum, dssq, n_nodes)
        return (dx12, dp, dk12, dk3, dlin_bias, dbn_scale, dbn_bias,
                None, None, None, None, None)


def assign_tail_train_psum(x12, p, k12, k3, lin_bias, bn_scale, bn_bias,
                           n_nodes, n, eps=1e-5, c_out=None, axis=ONE):
    """(S [B, N, c_out or C], mean, var) — :class:`AssignTailTrainPsum`."""
    return AssignTailTrainPsum.apply(x12, p, k12, k3, lin_bias, bn_scale,
                                     bn_bias, n_nodes, n, eps, c_out, axis)


# ---------------------------------------------------------------------------
# the capacity path: B9a, B9b and the chunked-recompute tail
# ---------------------------------------------------------------------------

def pick_chunk(nrows: int, target: int) -> int:
    """A legal chunk for ``target`` rows: a multiple of 128 capped at
    ``nrows``; 0 when chunking cannot apply. A non-dividing chunk leaves
    one remainder chunk."""
    if nrows % TILE or target < TILE:
        return 0
    return min(nrows, target // TILE * TILE)


def chunk_plan(nrows: int, chunk_rows: int) -> tuple[int, int, int]:
    """(chunk, full chunks, remainder rows) of ``nrows`` rows."""
    ch = min(chunk_rows, nrows)
    if ch % TILE or nrows % TILE or ch <= 0:
        raise ValueError(f"chunks of {ch} over {nrows} rows must tile by "
                         f"{TILE}")
    nfull = nrows // ch
    return ch, nfull, nrows - nfull * ch


def lin_p(x3: torch.Tensor, kc3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """conv3's lin output as the lin-fused kernels form it: the product in
    f32, rounded to x3's dtype, plus the bias in that dtype."""
    dt = x3.dtype
    return (x3.float() @ kc3.to(dt).float()).to(dt) + b3.to(dt)


def _check_lin(name, x3, kc3, b3, n_nodes) -> None:
    if x3.dim() != 3 or kc3.shape[0] != x3.shape[-1] \
            or b3.shape != (kc3.shape[1],) or n_nodes.shape != (x3.shape[0],):
        raise ValueError(
            f"{name}: x3 {tuple(x3.shape)} must be [B, N, F3], kc3 "
            f"{tuple(kc3.shape)} [F3, C], b3 {tuple(b3.shape)} [C], n_nodes "
            f"{tuple(n_nodes.shape)} [B]"
        )


def assign_head_softmax_pre_lin_plain(
    x12: torch.Tensor,      # [B, N, F12]
    x3: torch.Tensor,       # [B, N, F3] conv3's lin input
    kc3: torch.Tensor,      # [F3, C] conv3's lin kernel
    b3: torch.Tensor,       # [C] its bias
    k12: torch.Tensor,
    k3f: torch.Tensor,
    const: torch.Tensor,
    n_nodes: torch.Tensor,
) -> torch.Tensor:
    """S [B, N, C] of B4 with p = :func:`lin_p` (x3, kc3, b3)."""
    return assign_head_softmax_pre_plain(
        x12, lin_p(x3, kc3, b3), k12, k3f, const, n_nodes
    )[0]


def assign_head_softmax_pre_lin(x12, x3, kc3, b3, k12, k3f, const, n_nodes):
    """B9a. Same contract as :func:`assign_head_softmax_pre_lin_plain`;
    launches ``csrc/assign_head.cu`` (B4's kernels with the LIN switch) for
    CUDA tensors."""
    _check_lin("assign_head_softmax_pre_lin", x3, kc3, b3, n_nodes)
    b, n, _ = x3.shape
    c = kc3.shape[1]
    f12 = x12.shape[-1]
    if x12.shape[:2] != (b, n) or k12.shape != (f12, c) \
            or k3f.shape != (c, c) or const.shape != (c,) \
            or x12.dtype != x3.dtype:
        raise ValueError(
            f"assign_head_softmax_pre_lin: x12 {tuple(x12.shape)} "
            f"{x12.dtype}, k12 {tuple(k12.shape)}, k3f {tuple(k3f.shape)}, "
            f"const {tuple(const.shape)} disagree with x3 {tuple(x3.shape)} "
            f"{x3.dtype} and C={c}"
        )
    if x3.device.type == "cpu":
        return assign_head_softmax_pre_lin_plain(x12, x3, kc3, b3, k12, k3f,
                                                 const, n_nodes)
    dt = x3.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"assign_head_softmax_pre_lin: unsupported {dt}")
    if n % TILE:
        raise ValueError(f"assign_head_softmax_pre_lin: N={n} must tile by "
                         f"{TILE}")
    x12, x3 = x12.contiguous(), x3.contiguous()
    bf = dt == torch.bfloat16
    b3 = b3.to(dt).contiguous()
    # bf16 reads only the padded copies (made below, cast as they are copied)
    wdt = kc3.dtype if bf else dt
    kc3 = kc3.to(wdt).contiguous()
    k12, k3f = k12.to(wdt).contiguous(), k3f.to(wdt).contiguous()
    const = const.to(torch.float32).contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    _cuda.require_cuda("assign_head_softmax_pre_lin", x12, x3, kc3, b3, k12,
                       k3f, const, n_nodes)
    s = torch.empty((b, n, c), dtype=dt, device=x3.device)
    logits = s if dt == torch.float32 else torch.empty(
        (b, n, c), dtype=torch.float32, device=x3.device
    )
    rnorm = torch.empty((b * n,), dtype=torch.float32, device=x3.device)
    # bf16 runs on the tensor cores, which read padded weight copies; the
    # row norm (which reads kc3t) goes first, so the card works while the
    # head's weights are padded; each entry reads either the padded copies
    # (bf16; it checks their shapes) or kc3, k12 and k3f (f32)
    kc3t = pad_lin_kernel(kc3) if bf else None
    kc3_ = None if bf else kc3
    _cuda.launch(
        "cgc_assign_head_rnorm", None, x3.data_ptr(), _ptr(kc3_),
        _ptr(kc3t), b3.data_ptr(), n_nodes.data_ptr(), rnorm.data_ptr(), b,
        n, x3.shape[-1], c, *_shape2(kc3t), _cuda.DTYPE_CODES[dt],
        x3.device.index, _cuda.stream_of(x3),
    )
    wpad = pad_head_weights(k12, k3f) if bf else None
    _cuda.launch(
        "cgc_assign_head_pre_lin",
        x12.data_ptr(), x3.data_ptr(), _ptr(kc3_), b3.data_ptr(),
        _ptr(kc3t), _ptr(None if bf else k12), _ptr(None if bf else k3f),
        _ptr(wpad), const.data_ptr(), n_nodes.data_ptr(),
        rnorm.data_ptr(), logits.data_ptr(), s.data_ptr(), b, n, f12,
        x3.shape[-1], c, *_shape2(wpad), *_shape2(kc3t),
        _cuda.DTYPE_CODES[dt], x3.device.index, _cuda.stream_of(x3),
    )
    assign_head_softmax_pre_lin.launches += 1
    _B9A_VARIANTS[head_product(dt)] += 1
    return s


assign_head_softmax_pre_lin.launches = 0
assign_head_softmax_pre_lin.variants = _B9A_VARIANTS = Counter()


def l2relu_stats_lin_plain(x3, kc3, b3, n_nodes):
    """(sum[C], sumsq[C]) of B3 with p = :func:`lin_p` (x3, kc3, b3)."""
    return l2relu_stats_plain(lin_p(x3, kc3, b3), n_nodes)


def l2relu_stats_lin(x3, kc3, b3, n_nodes):
    """B9b. Same contract as :func:`l2relu_stats_lin_plain`; launches
    ``csrc/assign_tail.cu`` for CUDA tensors: in bf16 p and its row norm on
    the tensor cores through B9a's routines (over ``pad_lin_kernel``'s copy
    of kc3, so F3 <= 32; N a multiple of ``STATS_ROWS``), in f32 B3's
    kernel with the LIN switch (each row's p formed once)."""
    _check_lin("l2relu_stats_lin", x3, kc3, b3, n_nodes)
    if x3.device.type == "cpu":
        return l2relu_stats_lin_plain(x3, kc3, b3, n_nodes)
    b, n, f3 = x3.shape
    c = kc3.shape[1]
    dt = x3.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"l2relu_stats_lin: unsupported dtype {dt}")
    bf = dt == torch.bfloat16
    if bf and n % STATS_ROWS:
        raise ValueError(f"l2relu_stats_lin: N={n} must tile by {STATS_ROWS}")
    x3 = x3.contiguous()
    b3 = b3.to(dt).contiguous()
    n_nodes = n_nodes.to(torch.int32).contiguous()
    kc3 = kc3.contiguous() if bf else kc3.to(dt).contiguous()
    _cuda.require_cuda("l2relu_stats_lin", x3, kc3, b3, n_nodes)
    # bf16 reads only the padded transposed copy (cast as it is copied)
    kc3t = pad_lin_kernel(kc3) if bf else None
    parts = b * n // STATS_ROWS if bf else STATS_BLOCKS
    partial = torch.empty((parts, 2, c), dtype=torch.float32, device=x3.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x3.device)
    _cuda.launch(
        "cgc_l2relu_stats_lin",
        x3.data_ptr(), _ptr(None if bf else kc3), _ptr(kc3t), b3.data_ptr(),
        n_nodes.data_ptr(), partial.data_ptr(), out.data_ptr(), None, b, n,
        f3, c, *_shape2(kc3t), parts, _cuda.DTYPE_CODES[dt],
        x3.device.index, _cuda.stream_of(x3),
    )
    l2relu_stats_lin.launches += 1
    return out[0], out[1]


l2relu_stats_lin.launches = 0


def l2relu_stats_lin_reference(x3, kc3, b3, n_nodes):
    """:func:`l2relu_stats_reference` of p = :func:`lin_p` (x3, kc3, b3),
    the p of :func:`l2relu_stats_lin_plain`: B9b's exact yardstick. No path
    of the package calls it."""
    return l2relu_stats_reference(lin_p(x3, kc3, b3), n_nodes)


# ---------------------------------------------------------------------------
# The statistics hold (chip_smoke.py, phase 10): B3's and B9b's statistics
# against the exact ones, between two witnesses. No path calls these.
# ---------------------------------------------------------------------------

# Each column's sum and sum of squares against the exact ones, as
# |stat - exact| / |exact|, the max over the 2C statistics. A right
# computation errs by its f32 sums (a few 1e-7 to 1e-6) and by the rare
# values that a right p or row norm of another summation order rounds to
# the neighbouring bf16 step; a computation one rounding step off moves most
# values of every column by up to half a step. On the H100, at the whole
# slide's 100352 rows (bf16), the readings the limit was set from were: B3
# kernel 1.251e-6, witness (i) 4.211e-6, witness (ii) 1.412e-4; B9b kernel
# 1.251e-6, witness (i) 1.091e-6, witness (ii) 3.567e-3. 2^-15 sits near the
# geometric middle of B3's two witnesses (2.4e-5), 7x above witness (i) and
# 4.6x below witness (ii). The limit is for that size: a right
# computation's distance falls as 1 / rows (a flip against its column's
# sum), a wrong one's as 1 / sqrt(rows), so at a few hundred rows one flip
# of a right computation reads ~4e-5; from ~4096 rows on it sits below.
STATS_TOL = 2.0 ** -15
# The kernels whose output, the BN statistics, the statistics hold judges
# at STATS_TOL. ``chip_smoke.py``'s step holds (phases 9 and 10) route
# these sites to the kernel on both sides, so the plain bf16 step and the
# kernel step read the same statistics bit for bit, and hold everything
# downstream of them: the capacity step's loss and gradients jump between
# outcomes on the statistics' last bits (the exact statistics fail its loss
# rule), so it cannot judge them itself.
STATS_HELD = ("B3", "B9b")


def stats_distance(got, ref) -> float:
    """max over the columns of (sum, sumsq) of |got - ref| / |ref|; a column
    whose exact sum is 0 (no positive h) counts 0 where got is 0, else
    inf."""
    worst = 0.0
    for g, r in zip(got, ref):
        d = (g.double() - r).abs()
        rel = d / r.abs()
        zero = r == 0
        rel[zero] = torch.where(d[zero] == 0, 0.0, float("inf")).double()
        worst = max(worst, rel.max().item())
    return worst


def rnorm_two_halves(p: torch.Tensor) -> torch.Tensor:
    """B3's witness (i): the plain row norm with its sum of squares taken
    as two half-row sums — a right row norm summed in another order."""
    pf = p.float()
    half = pf.shape[-1] // 2
    lo, hi = pf[..., :half], pf[..., half:]
    ss = (lo * lo).sum(-1, keepdim=True) + (hi * hi).sum(-1, keepdim=True)
    return 1.0 / torch.clamp_min(torch.sqrt(ss), 1e-12)


def lin_p_reversed(x3, kc3, b3) -> torch.Tensor:
    """B9b's witness (i): p = round_T(round_T(dot) + b3) with the F3-term
    dot summed in reverse order, one f32 rounding per product and per
    addition — a right p by another route."""
    dt = x3.dtype
    xf, kf = x3.float(), kc3.to(dt).float()
    dot = xf[..., -1:] * kf[-1]
    for k in range(kf.shape[0] - 2, -1, -1):
        dot = dot + xf[..., k:k + 1] * kf[k]
    return dot.to(dt) + b3.to(dt)


def lin_p_rounded_once(x3, kc3, b3) -> torch.Tensor:
    """B9b's witness (ii): round_T(dot + b3), one rounding where the
    function has two — a p one rounding step off."""
    dt = x3.dtype
    return (x3.float() @ kc3.to(dt).float() + b3.to(dt).float()).to(dt)


class AssignTailTrainChunkedLin(torch.autograd.Function):
    """The capacity path's training tail: ``AssignTailTrainPsum`` with
    conv3's lin inside (B9b for the statistics, B9a for S), so no [N, C]
    tensor of the conv3 stream exists; S is not saved either. The backward
    (``_atcl_bwd``) sweeps the rows twice in chunks of ``chunk_rows``,
    recomputing S (B9a) and p per chunk: phase A sums the [C]-sized
    reductions (dk12, dk3f, dconst), phase B — with the statistics'
    cotangents known — writes dx12 and dx3 and sums dkc3, db3 through one B5
    launch per chunk. Returns (S, batch mean, batch var)."""

    @staticmethod
    def forward(ctx, x12, x3, kc3, b3, k12, k3, lin_bias, bn_scale, bn_bias,
                n_nodes, n, eps, chunk_rows, axis):
        ssum, ssq = l2relu_stats_lin(x3, kc3, b3, n_nodes)
        ssum, ssq = mega_graph.psum(ssum, axis), mega_graph.psum(ssq, axis)
        k3f, const, mean, var = tail_algebra(
            ssum, ssq, k3, lin_bias, bn_scale, bn_bias, n, eps
        )
        s = assign_head_softmax_pre_lin(x12, x3, kc3, b3, k12, k3f, const,
                                        n_nodes)
        ctx.save_for_backward(x12, x3, kc3, b3, k12, k3f, const, n_nodes,
                              ssum, ssq, k3, lin_bias, bn_scale, bn_bias, n)
        ctx.eps, ctx.chunk_rows, ctx.axis = eps, chunk_rows, axis
        ctx.mark_non_differentiable(mean, var)
        return s, mean, var

    @staticmethod
    def backward(ctx, ds, _dmean, _dvar):
        (x12, x3, kc3, b3, k12, k3f, const, n_nodes, ssum, ssq, k3, lin_bias,
         bn_scale, bn_bias, n) = ctx.saved_tensors
        _, nrows, f3 = x3.shape
        c = kc3.shape[1]
        dt = x3.dtype
        ch, nfull, rem = chunk_plan(nrows, ctx.chunk_rows)
        spans = [(i * ch, ch) for i in range(nfull)]
        if rem:
            spans.append((nfull * ch, rem))

        def dl_of(lo, size):
            """Chunk-local recompute: S by B9a (the forward's kernel, so the
            same bits), p by the plain lin, the masked-softmax fold."""
            x3c = x3[:, lo:lo + size]
            xc = x12[:, lo:lo + size]
            nn_c = torch.clamp(n_nodes.long() - lo, 0, size).to(n_nodes.dtype)
            sc = assign_head_softmax_pre_lin(xc, x3c, kc3, b3, k12, k3f,
                                             const, nn_c)
            dl, dl32 = _softmax_vjp(sc, ds[:, lo:lo + size])
            return xc, x3c, lin_p(x3c, kc3, b3), nn_c, dl32, dl

        # ---- phase A: the [C]-sized reductions ----
        dk12 = x3.new_zeros((x12.shape[-1], c), dtype=torch.float32)
        dk3f = x3.new_zeros((c, c), dtype=torch.float32)
        dconst = x3.new_zeros((c,), dtype=torch.float32)
        for lo, size in spans:
            xc, _, pc, nn_c, dl32, dl = dl_of(lo, size)
            dk12 += torch.einsum("bnf,bnc->fc", xc.float(), dl.float())
            _, h32 = _rnorm_h(pc.float())
            hc = (h32 * _prefix_mask(nn_c, size)[..., None]).to(dt)
            dk3f += torch.einsum("bnc,bnd->cd", hc.float(), dl.float())
            dconst += torch.sum(dl32, dim=(0, 1))
        dssum, dssq, dk3, dlin_bias, dbn_scale, dbn_bias = _alg_grads(
            (ssum, ssq, k3, lin_bias, bn_scale, bn_bias), n, ctx.eps,
            dk3f, dconst, mega_graph.psum(dk3f, ctx.axis),
            mega_graph.psum(dconst, ctx.axis),
        )

        # ---- phase B: the row gradients; dp exists per chunk only ----
        dx12 = torch.zeros_like(x12)
        dx3 = torch.zeros_like(x3)
        dkc3 = x3.new_zeros((f3, c), dtype=torch.float32)
        db3 = x3.new_zeros((c,), dtype=torch.float32)
        for lo, size in spans:
            xc, x3c, pc, nn_c, dl32, dl = dl_of(lo, size)
            dh = dl @ k3f.to(dl.dtype).t()
            dpc = assign_tail_bwd(pc, dh, dssum, dssq, nn_c)
            dx12[:, lo:lo + size] = (dl @ k12.to(dl.dtype).t()).to(dx12.dtype)
            dx3[:, lo:lo + size] = (dpc @ kc3.to(dpc.dtype).t()).to(dx3.dtype)
            dkc3 += torch.einsum("bnf,bnc->fc", x3c.float(), dpc.float())
            db3 += torch.sum(dpc.float(), dim=(0, 1))
        return (dx12, dx3, dkc3.to(kc3.dtype), db3.to(b3.dtype),
                dk12.to(k12.dtype), dk3, dlin_bias, dbn_scale, dbn_bias,
                None, None, None, None, None)


def assign_tail_train_chunked_lin(x12, x3, kc3, b3, k12, k3, lin_bias,
                                  bn_scale, bn_bias, n_nodes, n, eps=1e-5,
                                  chunk_rows=65536, axis=ONE):
    """(S [B, N, C], mean, var) — :class:`AssignTailTrainChunkedLin`."""
    return AssignTailTrainChunkedLin.apply(
        x12, x3, kc3, b3, k12, k3, lin_bias, bn_scale, bn_bias, n_nodes, n,
        eps, chunk_rows, axis,
    )
