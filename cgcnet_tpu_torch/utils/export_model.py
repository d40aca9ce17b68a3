"""Serialized model export for serving (``torch.export``).

Port of ``cgcnet_tpu/utils/export_model.py``, which writes a ``jax.export``
StableHLO artifact. This one traces the eval-mode forward with
``torch.export`` and writes its own single file:

    8-byte little-endian header length | JSON header | torch.export.save payload

The JSON header (magic ``cgcnet_tpu_torch.export.v1``) records the
``CellGraph`` fields the program takes, in call order, with their shapes
and dtypes, whether the batch is symbolic, the device, the torch version and
what loading needs — enough for a serving layer to validate inputs without
deserializing the payload.

Two kinds of artifact, chosen by the caller, never as a fallback:

- **the kernel artifact** (``device`` cuda): traced on the card through the
  block path, so the program records the hand-written kernels as custom ops
  (``torch.ops.cgcnet_tpu_torch.bsr_build_blocks``, ``bsr_matmul``,
  ``assign_head_softmax_pre`` / ``assign_head_softmax``) and launches them
  when it runs. Loading it needs ``import cgcnet_tpu_torch.ops``, which
  registers them (``load_exported`` does it). Its signature takes the
  loader's transpose tables and block metadata; the block-slot counts M of
  both directions and the transpose width are symbolic dimensions, so a
  batch serves with whatever grow-only slot caps the loader gave it.
- **the portable artifact** (``device`` cpu): traced on the CPU through the
  ELL gather path (no block metadata in its signature, no custom op), served
  on the CPU.

Loading an artifact onto another device than its header's raises.
"""

from __future__ import annotations

import io
import json
import struct as _struct
from pathlib import Path
from typing import Callable

import torch

from cgcnet_tpu_torch.core.graph import CellGraph

# CellGraph fields an exported forward may consume, in canonical call order.
# Label/metrics fields (y, patch_idx) are never part of a serving signature.
_EXPORTABLE_FIELDS = (
    "x", "nbr", "nbr_mask", "n_nodes", "nbr_w", "nbr_t", "nbr_t_mask",
    "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t",
)

_MAGIC = "cgcnet_tpu_torch.export.v1"
KERNEL_OPS = "import cgcnet_tpu_torch.ops"

# symbolic dimensions besides the batch: {field: {axis: name}}
_SLOT_DIMS = {
    "blk_cols": {2: "m"}, "blk_mask": {2: "m"},
    "blk_cols_t": {2: "mt"}, "blk_mask_t": {2: "mt"},
    "nbr_t": {2: "kt"}, "nbr_t_mask": {2: "kt"},
}


class _Forward(torch.nn.Module):
    """``model(CellGraph(fields...))`` over positional tensors."""

    def __init__(self, model: torch.nn.Module, fields: list[str]):
        super().__init__()
        self.model = model
        self.fields = fields

    def forward(self, *arrays: torch.Tensor) -> torch.Tensor:
        return self.model(CellGraph(**dict(zip(self.fields, arrays))))


def export_forward(
    model: torch.nn.Module, graph: CellGraph, *, symbolic_batch: bool = False
):
    """Export ``model(graph)`` in eval mode -> logits.

    Returns ``(program, header)``: ``program`` is the
    ``torch.export.ExportedProgram`` taking the graph's non-None exportable
    fields as positional tensors, and ``header`` the JSON-able metadata.
    The graph's device picks the artifact: a CUDA graph records the kernels
    as custom ops (the kernel artifact), a CPU graph traces the plain
    PyTorch path (the portable artifact). ``symbolic_batch`` makes the
    leading (batch) dimension symbolic so one artifact serves any batch
    size; the node capacity stays static."""
    import cgcnet_tpu_torch.ops  # noqa: F401  (registers the custom ops)

    device = graph.x.device
    if any(p.device != device for p in model.parameters()):
        raise ValueError(f"export_forward: model and graph ({device}) must "
                         "lie on one device")
    fields = [f for f in _EXPORTABLE_FIELDS if getattr(graph, f) is not None]
    args = tuple(getattr(graph, f) for f in fields)
    names, dims = {}, []
    for f, a in zip(fields, args):
        axes = dict(_SLOT_DIMS.get(f, {}))
        if symbolic_batch:
            axes[0] = "b"
        for ax, name in axes.items():
            if name not in names:
                # the batch can be 1; the slot counts and widths are >= 2
                names[name] = torch.export.Dim(
                    name, min=1 if name == "b" else 2)
        dims.append({ax: names[name] for ax, name in axes.items()} or None)
    model = model.eval()
    with torch.no_grad():
        program = torch.export.export(
            _Forward(model, fields), args,
            dynamic_shapes={"arrays": tuple(dims)})
    custom = sorted({
        str(n.target) for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("cgcnet_tpu_torch.")
    })
    header = {
        "magic": _MAGIC,
        "fields": fields,
        "inputs": {
            f: {
                "shape": [
                    {**_SLOT_DIMS.get(f, {}), **({0: "b"} if symbolic_batch else {})}
                    .get(ax, int(d))
                    for ax, d in enumerate(a.shape)
                ],
                "dtype": str(a.dtype).replace("torch.", ""),
            }
            for f, a in zip(fields, args)
        },
        "symbolic_batch": symbolic_batch,
        "device": device.type,
        "custom_ops": custom,
        "requires": KERNEL_OPS if custom else None,
        "torch_version": torch.__version__,
    }
    return program, header


def save_exported(program, header: dict, path: str | Path) -> Path:
    """Write header + serialized program as one file."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    head = json.dumps(header).encode("utf-8")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("wb") as f:
        f.write(_struct.pack("<Q", len(head)))
        f.write(head)
        f.write(buf.getvalue())
    return path


def read_header(path: str | Path) -> tuple[dict, bytes]:
    """(header, payload) of an artifact; raises on a foreign file."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a {_MAGIC} artifact")
    (hlen,) = _struct.unpack("<Q", raw[:8])
    try:
        header = json.loads(raw[8 : 8 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        header = None
    if not isinstance(header, dict) or header.get("magic") != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} artifact")
    return header, raw[8 + hlen :]


def load_exported(
    path: str | Path,
) -> tuple[Callable[[CellGraph], torch.Tensor], dict]:
    """Load an artifact -> ``(forward(graph) -> logits, header)``.

    The returned callable pulls the recorded fields off a CellGraph (or any
    object with those attributes), checks each one's device, dtype and
    static dimensions against the header, and runs the program. A kernel
    artifact needs a card here."""
    import cgcnet_tpu_torch.ops  # noqa: F401  (the kernel artifact's ops)

    header, payload = read_header(path)
    device = header["device"]
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{path}: a kernel artifact (device cuda) needs a CUDA device; "
            "export the portable artifact (--cpu) to serve on the CPU"
        )
    program = torch.export.load(io.BytesIO(payload)).module()
    fields = header["fields"]

    def forward(graph) -> torch.Tensor:
        args = []
        for f in fields:
            a = getattr(graph, f, None)
            if a is None:
                raise ValueError(
                    f"exported model needs graph field {f!r} "
                    f"(artifact fields: {fields})"
                )
            spec = header["inputs"][f]
            if a.device.type != device:
                raise ValueError(
                    f"field {f!r} lies on {a.device}; the artifact was "
                    f"exported for {device}"
                )
            want = spec["shape"]
            if str(a.dtype).replace("torch.", "") != spec["dtype"] or (
                a.dim() != len(want)
                or any(isinstance(w, int) and w != d
                       for w, d in zip(want, a.shape))
            ):
                raise ValueError(
                    f"field {f!r}: {a.dtype} {tuple(a.shape)} does not fit "
                    f"{spec['dtype']} {want}"
                )
            args.append(a)
        with torch.no_grad():
            return program(*args)

    return forward, header
