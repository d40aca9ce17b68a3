"""Plain reference of CGC-Net (arXiv 1909.01068; the reference repository's
``SoftPoolingGcnEncoder`` with SAGE, relu, BatchNorm, LSTM jumping
knowledge, adaptive adjacency renormalization and a max readout per stage).

Written from the model's description, in float32 plain PyTorch: no kernel,
no padding, no fused tail. The graphs of a batch are laid end to end (their
real nodes only); stage 1 multiplies by one sparse block-diagonal adjacency
(``torch.sparse.mm``), DiffPool contracts each graph on its own, and the
pooled stages are dense batched products.

- Stage-1 adjacency: A[i, i] = p and A[i, j] = (1 - p) / (deg_i + 1e-15)
  for each of node i's other neighbours j (p = ``self_weight`` 0.4).
- SAGE layer: h' = W (A h) / max(rowsum(A), 1) + b, row L2-normalized,
  relu, BatchNorm (batch moments over every real node in training, biased
  variance; the running moments in eval).
- Pooling block: three layers, the third ``assign`` wide; lin over the
  concat of the three -> assignment logits; S = softmax over clusters.
- DiffPool: X' = S^T E, A' = S^T A S; then A' renormalized (zero
  diagonal, rows scaled to 1 - p over their sum + 1e-15, diagonal p).
- Jumping knowledge: a bidirectional LSTM (hidden 3C/2) over the three
  layer outputs, a linear score per layer, softmax, weighted sum.
- Head: concat of the three stages' max readouts, Linear(60, 50), relu,
  dropout (keep masks drawn with ``torch.rand`` from the given generator),
  Linear(50, 3).

``quant`` rounds the operands of every product, forward and backward (the
control's lower precision: TF32, which rounds products only); the identity
gives float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-15


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits (nearest, ties to even)."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


# the reference's precisions: float32 (``identity``) and the control, TF32
# for float32 with TF32 off
CONTROLS = {"identity": {"quant": identity}, "tf32": {"quant": tf32}}


class _QuantMatmul(torch.autograd.Function):
    """a @ b with both operands rounded by ``quant``, and the backward's
    two products with theirs rounded too (as a lower-precision GEMM
    rounds every product it runs)."""

    @staticmethod
    def forward(ctx, a, b, quant):
        ctx.save_for_backward(a, b)
        ctx.quant = quant
        return quant(a) @ quant(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.quant
        gq = q(g)
        ga = gq @ q(b).transpose(-1, -2)
        if b.dim() == 2 and a.dim() > 2:
            gb = q(a).reshape(-1, a.shape[-1]).t() @ gq.reshape(-1, g.shape[-1])
        else:
            gb = q(a).transpose(-1, -2) @ gq
        return ga, gb, None


class _QuantSpmm(torch.autograd.Function):
    """A @ h for a constant sparse A, h and the cotangent rounded."""

    @staticmethod
    def forward(ctx, h, a, a_t, quant):
        ctx.a_t, ctx.quant = a_t, quant
        return torch.sparse.mm(a, quant(h))

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.a_t, ctx.quant(g)), None, None, None


def mm(a, b, quant):
    if quant is identity:
        return a @ b
    return _QuantMatmul.apply(a, b, quant)


def spmm(a, a_t, h, quant):
    if quant is identity:
        return torch.sparse.mm(a, h)
    return _QuantSpmm.apply(h, a, a_t, quant)


def l2norm(h):
    return F.normalize(h, p=2.0, dim=-1, eps=1e-12)


def batchnorm(h, P, B, name, train):
    """BatchNorm over every row of ``h`` (biased variance, eps 1e-5): the
    batch's moments (two passes) in training, the running moments in
    eval."""
    if train:
        rows = h.reshape(-1, h.shape[-1])
        d = (rows - rows.mean(0)).reshape(h.shape)
        var = (d * d).reshape(rows.shape).mean(0)
    else:
        d = h - B[f"{name}.running_mean"]
        var = B[f"{name}.running_var"]
    return d * (torch.rsqrt(var + 1e-5) * P[f"{name}.weight"]) \
        + P[f"{name}.bias"]


def linear(h, P, name, quant):
    return mm(h, P[f"{name}.weight"].t(), quant) + P[f"{name}.bias"]


def sage_block(P, B, blk, h, agg, denom, train, quant, lin: bool):
    """Three SAGE layers; ``agg(h)`` is A @ h. Returns the concat of the
    three outputs (embedding blocks) or the lin over it (pooling blocks)."""
    outs = []
    for i in (1, 2, 3):
        z = linear(agg(h) / denom, P, f"{blk}.gcn{i}.lin", quant)
        h = batchnorm(torch.relu(l2norm(z)), P, B, f"{blk}.bn{i}", train)
        outs.append(h)
    cat = torch.cat(outs, -1)
    return linear(cat, P, f"{blk}.lin", quant) if lin else cat


def lstm_dir(P, pre, sfx, steps, quant):
    w_ih, w_hh = P[f"{pre}.weight_ih{sfx}"], P[f"{pre}.weight_hh{sfx}"]
    bias = P[f"{pre}.bias_ih{sfx}"] + P[f"{pre}.bias_hh{sfx}"]
    hdim = w_hh.shape[1]
    h = c = None
    out = []
    for x in steps:
        g = mm(x, w_ih.t(), quant) + bias
        if h is not None:
            g = g + mm(h, w_hh.t(), quant)
        i, f, gg, o = torch.split(g, hdim, -1)
        cn = torch.sigmoid(i) * torch.tanh(gg)
        c = cn if c is None else torch.sigmoid(f) * c + cn
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return out


def jumping_knowledge(P, name, cat, quant, layers: int = 3):
    shape = cat.shape
    steps = list(torch.split(cat.reshape(-1, shape[-1]), shape[-1] // layers,
                             -1))
    fwd = lstm_dir(P, f"{name}.lstm", "_l0", steps, quant)
    bwd = lstm_dir(P, f"{name}.lstm", "_l0_reverse", steps[::-1], quant)[::-1]
    w = P[f"{name}.att.weight"].t()
    score = torch.cat([mm(torch.cat([f, b], -1), w, quant)
                       for f, b in zip(fwd, bwd)], -1) + P[f"{name}.att.bias"]
    alpha = torch.softmax(score, -1)
    out = sum(alpha[:, j:j + 1] * steps[j] for j in range(layers))
    return out.reshape(*shape[:-1], shape[-1] // layers)


def renorm_dense(adj, p):
    eye = torch.eye(adj.shape[-1], dtype=torch.bool, device=adj.device)
    off = adj.masked_fill(eye, 0.0)
    new = off / (off.sum(-1, keepdim=True) + EPS) * (1.0 - p)
    return new.masked_fill(eye, p)


def stage1_adjacency(graphs, p):
    """The batch's block-diagonal stage-1 adjacency (sparse COO)."""
    rows, cols, vals, off = [], [], [], 0
    for g in graphs:
        n, k = g["nbr"].shape
        me = torch.arange(n, device=g["nbr"].device)[:, None].expand(n, k)
        other = (g["mask"] > 0) & (g["nbr"] != me)
        deg = other.sum(-1).float()
        w = ((1.0 - p) / (deg + EPS))[:, None].expand(n, k)
        rows += [me[other] + off, torch.arange(n, device=me.device) + off]
        cols += [g["nbr"][other] + off, torch.arange(n, device=me.device) + off]
        vals += [w[other], torch.full((n,), p, device=me.device)]
        off += n
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(vals), (off, off)).coalesce()


def forward(P, B, graphs, *, train: bool, generator=None, drop: float = 0.2,
            p: float = 0.4, quant=identity) -> torch.Tensor:
    """Logits [len(graphs), classes] of the batch ``graphs`` (each a dict
    of x [n, F], nbr [n, K], mask [n, K]) under parameters ``P`` and
    running moments ``B`` (dicts by the reference module names)."""
    sizes = [g["x"].shape[0] for g in graphs]
    a1 = stage1_adjacency(graphs, p)
    a1_t = a1.t().coalesce() if quant is not identity else None
    x = torch.cat([g["x"] for g in graphs]).float()
    agg1 = lambda h: spmm(a1, a1_t, h, quant)
    emb = sage_block(P, B, "embed1", x, agg1, 1.0, train, quant, False)
    logit1 = sage_block(P, B, "pool1", x, agg1, 1.0, train, quant, True)
    emb = jumping_knowledge(P, "jk1", emb, quant)
    s = torch.softmax(logit1, -1)
    a_s = agg1(s)
    reads1, xs, adjs = [], [], []
    for e_i, s_i, as_i in zip(emb.split(sizes), s.split(sizes),
                              a_s.split(sizes)):
        reads1.append(e_i.amax(0))
        xs.append(mm(s_i.t(), e_i, quant))
        adjs.append(mm(s_i.t(), as_i, quant))
    x2 = torch.stack(xs)
    a2 = renorm_dense(torch.stack(adjs), p)

    def dense(adj):
        denom = adj.sum(-1, keepdim=True).clamp_min(1.0)
        return (lambda h: mm(adj, h, quant)), denom

    agg2, den2 = dense(a2)
    emb2 = sage_block(P, B, "embed2", x2, agg2, den2, train, quant, False)
    logit2 = sage_block(P, B, "pool2", x2, agg2, den2, train, quant, True)
    emb2 = jumping_knowledge(P, "jk2", emb2, quant)
    s2 = torch.softmax(logit2, -1)
    x3 = mm(s2.transpose(1, 2), emb2, quant)
    a3 = renorm_dense(mm(s2.transpose(1, 2), mm(a2, s2, quant), quant), p)
    agg3, den3 = dense(a3)
    emb3 = sage_block(P, B, "embed3", x3, agg3, den3, train, quant, False)
    emb3 = jumping_knowledge(P, "jk3", emb3, quant)
    h = torch.cat([torch.stack(reads1), emb2.amax(1), emb3.amax(1)], -1)
    h = torch.relu(linear(h, P, "pred_0", quant))
    if train and drop > 0:
        keep = 1.0 - drop
        u = torch.rand(h.shape, generator=generator, device=h.device)
        h = torch.where(u < keep, h / keep, torch.zeros_like(h))
    return linear(h, P, "pred_out", quant)


def parameter_shapes(input_dim=18, hidden=20, assign=(1140, 114),
                     classes=3, pred_hidden=50) -> dict:
    """Name -> shape of every parameter, in the order of the published
    module tree (torch's layouts: Linear [out, in], LSTM [4H, in])."""
    shapes = {}

    def block(name, fin, out3, lin):
        dims = [(fin, hidden), (hidden, hidden), (hidden, out3)]
        for i, (a, b) in enumerate(dims, 1):
            shapes[f"{name}.gcn{i}.lin.weight"] = (b, a)
            shapes[f"{name}.gcn{i}.lin.bias"] = (b,)
        for i, b in enumerate((hidden, hidden, out3), 1):
            shapes[f"{name}.bn{i}.weight"] = (b,)
            shapes[f"{name}.bn{i}.bias"] = (b,)
        if lin:
            shapes[f"{name}.lin.weight"] = (out3, 2 * hidden + out3)
            shapes[f"{name}.lin.bias"] = (out3,)

    block("embed1", input_dim, hidden, False)
    block("pool1", input_dim, assign[0], True)
    block("embed2", hidden, hidden, False)
    block("pool2", hidden, assign[1], True)
    block("embed3", hidden, hidden, False)
    lh = hidden * 3 // 2
    for j in (1, 2, 3):
        for sfx in ("_l0", "_l0_reverse"):
            shapes[f"jk{j}.lstm.weight_ih{sfx}"] = (4 * lh, hidden)
            shapes[f"jk{j}.lstm.weight_hh{sfx}"] = (4 * lh, lh)
            shapes[f"jk{j}.lstm.bias_ih{sfx}"] = (4 * lh,)
            shapes[f"jk{j}.lstm.bias_hh{sfx}"] = (4 * lh,)
        shapes[f"jk{j}.att.weight"] = (1, 2 * lh)
        shapes[f"jk{j}.att.bias"] = (1,)
    shapes["pred_0.weight"] = (pred_hidden, 3 * hidden)
    shapes["pred_0.bias"] = (pred_hidden,)
    shapes["pred_out.weight"] = (classes, pred_hidden)
    shapes["pred_out.bias"] = (classes,)
    return shapes


def init_bound(name: str, shapes: dict) -> float | None:
    """torch's default uniform bound of a parameter, 1 / sqrt(fan-in) (the
    LSTM's: 1 / sqrt(hidden)); None for BatchNorm's constants (1 and 0)."""
    if ".bn" in name:
        return None
    if ".lstm." in name:
        pre = name.split(".lstm.")[0]
        return shapes[f"{pre}.lstm.weight_hh_l0"][1] ** -0.5
    return shapes[name.rsplit(".", 1)[0] + ".weight"][1] ** -0.5
