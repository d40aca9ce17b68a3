#!/usr/bin/env python3
"""How far bf16 moves the stage-1 JK and embed1 gradients (``jk1.``,
``embed1.``) on the CPU, the numbers behind holding them in f32 only in
tests/test_torch_slide_bf16.py.

    python3 scripts/stage1_bf16_distances.py   # from the repository root

On that file's slide (2048 rows, 2000 nuclei, its bf16 configuration and
weights) it prints, for each of those gradient tensors, the max distance
from the port's f32 block-path result of: the port's bf16 block path, the
port's patch CGCNet in bf16 (the gather path), and JAX's patch CGCNet in
bf16 (jitted; XLA's excess precision on, as the test suite runs it, and
off) and in f32; with the ratio of the port's block path to JAX's. Uses the
test suite's helpers and the JAX package (CPU, ~2 min).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import conftest  # noqa: F401  (the suite's JAX CPU setup)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_slide_bf16 as t
    from cgcnet_tpu_torch.core.graph import CellGraph
    from cgcnet_tpu_torch.nn.model import CGCNet

    torch.set_num_threads(1)  # as the test file runs (its fixture)
    t.bk.set_interpret(True)
    t.jah.set_interpret(True)
    res = t.bf16_result()
    r16, r32 = res["r16"], res["r32"]
    _, variables, _, _ = t._models(t.BF16_CFG, 1)
    x, nbr, mask = t.strip_slide(*t.SLIDE)
    label = r16["label"]
    jgraph = t.JaxCellGraph(x=jnp.asarray(x)[None], nbr=jnp.asarray(nbr)[None],
                            nbr_mask=jnp.asarray(mask)[None],
                            n_nodes=jnp.asarray([t.SLIDE[1]], jnp.int32))

    def jax_grads(over: dict, excess: bool = True) -> dict:
        jcfg = t.JaxModelConfig(**dict(t.BF16_CFG, use_pallas="never", **over))

        def jloss(params):
            out, _ = t.JaxPatch(jcfg).apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jgraph, train=True, mutable=["batch_stats"])
            return -jax.nn.log_softmax(out[0].astype(jnp.float32))[label]

        opts = {} if excess else {"xla_allow_excess_precision": False}
        fn = jax.jit(jax.grad(jloss), compiler_options=opts)
        return t.state_dict_from_flax(
            {"params": jax.device_get(fn(variables["params"]))})

    def port_patch(dt: str) -> dict:
        tcfg = dataclasses.replace(r16["tcfg"], compute_dtype=dt,
                                   use_pallas="never")
        model = CGCNet(tcfg)
        model.load_state_dict(r16["model"].state_dict())
        model.train()
        graph = CellGraph(
            x=torch.from_numpy(x)[None], nbr=torch.from_numpy(nbr)[None],
            nbr_mask=torch.from_numpy(mask)[None],
            n_nodes=torch.tensor([t.SLIDE[1]], dtype=torch.int32))
        loss = -torch.log_softmax(model(graph)[0].float(), -1)[label]
        loss.backward()
        return {n: q.grad.float() for n, q in model.named_parameters()
                if q.grad is not None}

    others = {
        "port patch bf16": port_patch("bfloat16"),
        "JAX patch bf16": jax_grads({}),
        "JAX patch bf16, no excess precision": jax_grads({}, excess=False),
        "JAX patch f32": jax_grads({"compute_dtype": "float32"}),
    }
    print("max |g - port f32 block path| per tensor: port bf16 block path; "
          + "; ".join(others) + "; ratio of the first to JAX patch bf16 "
          "(excess precision on, off)")
    for name, g32 in r32["t_grads"].items():
        if not name.startswith(t.MEGA_JIT_FAULT):
            continue
        ref = g32.numpy()

        def dist(g):
            return float(np.abs(np.asarray(g.float()) - ref).max())

        d_port = dist(r16["t_grads"][name])
        d = [dist(o[name]) for o in others.values()]
        print(f"{name:32s} {d_port:9.4f} " + " ".join(f"{v:9.5f}" for v in d)
              + f"  ratio {d_port / max(d[1], 1e-12):.2f} "
              f"{d_port / max(d[2], 1e-12):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
