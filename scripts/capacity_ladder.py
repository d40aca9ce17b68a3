#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (the capacity ladder) on its own, on one
card: the kernels built, phase 4's seeded weights written to a checkpoint,
then chip_smoke's rungs, the default (no-chunk) step, the step hold, the
memory account and the ``cli.slide`` run at the rungs chosen here.

    python3 scripts/capacity_ladder.py --phase    # phase 14 as chip_smoke runs it
    python3 scripts/capacity_ladder.py --nuclei 100000,500000 \\
        --default 500000 --grad-hold 0 --account 500000 --no-cli --explore

``--explore`` records each rung under chip_smoke's ``memory_account``
(pass ``--account 0`` with it: the two do not nest) and lets a rung that
runs out of device memory report its peak (``max_memory_allocated`` when
the allocation failed), the allocator's message and the largest blocks
alive, then goes on with the next rung: it finds the sizes that fit and
what fills them. The phase itself never catches an out-of-memory error. The last line is one
JSON object of the rungs' numbers beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def sizes(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--nuclei", type=sizes, default=list(cs.LADDER_NUCLEI))
    p.add_argument("--default", type=int, default=cs.LADDER_DEFAULT,
                   help="rung of the default (no-chunk) step; 0 for none")
    p.add_argument("--grad-hold", type=sizes,
                   default=list(cs.LADDER_GRAD_HOLD),
                   help="rungs of the full step hold (comma-separated); 0 "
                        "for none")
    p.add_argument("--account", type=int, default=cs.LADDER_TOP,
                   help="rung of the memory account; 0 for none")
    p.add_argument("--no-cli", action="store_true",
                   help="skip the cli.slide run at the top rung")
    p.add_argument("--explore", action="store_true",
                   help="report a rung that runs out of memory and go on")
    p.add_argument("--phase", action="store_true",
                   help="run chip_smoke's ladder_phase as it is (the rung "
                        "options are ignored)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("capacity_ladder: no CUDA device", file=sys.stderr)
        return 2
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.ops import _cuda
    from cgcnet_tpu_torch.train.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _cuda.build()
    _cuda.library()
    cs.log(f"kernels built in {time.time() - t0:.1f} s")
    device = torch.device("cuda", 0)
    # phase 4's weights: the canonical model of chip_smoke's serving config
    pcfg = predict.serving_config([f"data.max_num_nodes={cs.DATA_NODES[1]}"])
    cfg = Config().apply_overrides(cs.SLIDE_DTYPE)
    rungs, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(
            Path(tmp) / "model_SAGE.pt",
            CGCNet(pcfg.model, torch.Generator().manual_seed(1234))
            .state_dict(), pcfg, {"origin": "chip_smoke random init, seed 1234"})
        if args.phase:
            out = cs.ladder_phase(Path(tmp), device, ckpt)
            print(json.dumps({"card": card, **out}))
            return 0

        def attempt(what, fn):
            if not args.explore:
                return fn()
            acct: dict = {}
            try:
                with cs.memory_account(acct):
                    return fn()
            except torch.cuda.OutOfMemoryError as e:
                peak = torch.cuda.max_memory_allocated() / 2**30
                msg = str(e).splitlines()[0]
                cs.log(f"  {what}: out of memory at a peak of {peak:.3f} GiB: "
                       f"{msg}; the largest blocks alive at the peak of the "
                       f"live bytes ({acct['peak_gib']:.3f} GiB):")
                for b in acct["blocks"]:
                    cs.log(f"    {b['gib']:.3f} GiB  {b['where']}"
                           + (f"  via {b['via']}" if b["via"] else ""))
                failed.append({"what": what, "peak_gib": peak, "error": msg,
                               "account": acct})
                torch.cuda.empty_cache()
                return None

        for n in args.nuclei:
            r = attempt(f"{n} nuclei", lambda n=n: cs.ladder_rung(
                n, cfg, ckpt, device, grad_hold=n in args.grad_hold,
                default=n == args.default, account=n == args.account))
            if r is not None:
                r.pop("counts"), r.pop("default_counts")
                rungs.append(r)
        cli = None
        if not args.no_cli:
            cli = attempt("cli.slide", lambda: cs.ladder_cli(ckpt, device))
    fit = (cs.peak_fit([(r["rows"], r["own_peak_gib"]) for r in rungs])
           if len(rungs) > 1 else None)
    if fit:
        cs.log(f"capacity step's own peak = {fit['fixed_gib']:.3f} GiB + "
               f"{fit['bytes_per_row']:.1f} bytes a row")
    print(json.dumps({"card": card, "rungs": rungs, "out_of_memory": failed,
                      "fit": fit, "cli": cli}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
