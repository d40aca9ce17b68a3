"""Plain reference of the training steps and the numbers that judge them.

``adam_steps`` follows the first steps of a run from the same weights, the
same batches and the same dropout generators: softmax cross entropy (mean
over the batch), autograd's gradients, then torch's Adam update written
out (weight decay added to the gradient, bias-corrected moments).

``train_gaps`` reads, leaf by leaf, the gap between the program's and the
reference's norms: of the first gradient as the optimizer received it, and
of each parameter's change over the steps; each gap over the larger of the
reference leaf's norm and the median leaf's; the worst leaf's, and the
worst step's gap of the losses. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone under Adam and are
left out of the change.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from reference import model as ref_model


def adam_steps(P0: dict, B: dict, batches: list, generators: list, *,
               lr: float, weight_decay: float, betas=(0.9, 0.999),
               eps: float = 1e-8, control: str = "identity",
               half_batch: bool = False) -> dict:
    """``batches``: (graphs, labels [b]) per step. Returns the losses, the
    first step's gradients as the optimizer received them, and the
    parameters after the last step. ``control`` names the precision
    (``reference/model.py: CONTROLS``); ``half_batch`` plants a fault, the
    loss taken over the first half of each batch alone."""
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first = [], None
    b1, b2 = betas
    for t, ((graphs, y), gen) in enumerate(zip(batches, generators), 1):
        logits = ref_model.forward(P, B, graphs, train=True, generator=gen,
                                   **ref_model.CONTROLS[control])
        keep = len(graphs) // 2 if half_batch else len(graphs)
        loss = F.cross_entropy(logits[:keep], y[:keep].long())
        grads = torch.autograd.grad(loss, list(P.values()),
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            seen = {}
            for (k, p), g in zip(P.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if weight_decay:
                    g = g + weight_decay * p
                seen[k] = g
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            if first is None:
                first = seen
        del logits, loss, grads
    return {"losses": losses, "grad1": first,
            "params": {k: p.detach() for k, p in P.items()}}


def _leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap of norms over the larger of the reference leaf's
    norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in names}
    floor = statistics.median(norms.values())
    return {k: abs(float(prog[k].float().norm()) - norms[k])
            / max(norms[k], floor) for k in names}


def train_gaps(prog: dict, ref: dict, p0: dict) -> dict:
    """The three numbers compared for a training cell (see the module's
    docstring); ``prog`` and ``ref`` as :func:`adam_steps` returns them."""
    names = list(ref["grad1"])
    gnorm = {k: float(ref["grad1"][k].norm()) for k in names}
    med = statistics.median(gnorm.values())
    moving = [k for k in names if gnorm[k] >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], names)
    change = _leaf_gaps(
        {k: prog["params"][k].float() - p0[k].float() for k in moving},
        {k: ref["params"][k] - p0[k].float() for k in moving}, moving)
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(prog["losses"], ref["losses"]))
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": loss, "grad_gap": grad[worst_g],
            "change_gap": change[worst_c], "grad_leaf": worst_g, "change_leaf": worst_c,
            "left_out": len(names) - len(moving)}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest gap of one logit over the largest reference logit of the
    same request; infinite when the shapes differ (answers missing)."""
    if prog.numel() != ref.numel():
        return float("inf")
    prog, ref = prog.float().reshape(ref.shape), ref.float()
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-12))
