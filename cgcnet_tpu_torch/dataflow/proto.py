"""On-disk patch protocol.

Replaces the reference's torch.save'd PyG ``Data`` pickles
(dataflow/prepare_cv_dataset.py:107, read at dataflow/data.py:237,253) with
compressed npz — no pickle execution, language-neutral, mmap-friendly.

Directory layout (mirrors the reference's proto tree, SURVEY.md §1 L2):

    <root>/proto/feature/<dataset>/<fold>/<grade_dir>/<patch>.npz

Each proto stores: features [N, 16] f32 (appearance), coords [N, 2] f32,
label scalar. The N x N distance table the reference materializes to disk
(construct_feature_graph.py:17-24) is *not* stored — at int16 it costs
~250 MB per large patch; we recompute distances on the fly (cheap, and the
C++ fast path exists for whole-slide scale).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class PatchProto:
    name: str                 # e.g. "fold_1/1_normal/patchA"
    features: np.ndarray      # [N, 16] f32 appearance features
    coords: np.ndarray        # [N, 2] f32 centroids (y, x) in tile pixels
    label: int

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    def full_features(self) -> np.ndarray:
        """[N, 18]: appearance ++ coords, the reference's 'ca' feature type
        (dataflow/prepare_cv_dataset.py:61)."""
        return np.concatenate([self.features, self.coords], axis=-1)


def proto_path(root: str | Path, name: str, dataset: str = "colorectal") -> Path:
    return Path(root) / "proto" / "feature" / dataset / f"{name}.npz"


def save_proto(root: str | Path, proto: PatchProto, dataset: str = "colorectal") -> Path:
    p = proto_path(root, proto.name, dataset)
    p.parent.mkdir(parents=True, exist_ok=True)
    # uncompressed: float features barely compress but zlib decompression
    # cost ~7 ms/patch in the hot loader path (load_proto reads both formats)
    np.savez(
        p,
        features=proto.features.astype(np.float32),
        coords=proto.coords.astype(np.float32),
        label=np.int64(proto.label),
    )
    return p


def load_proto(root: str | Path, name: str, dataset: str = "colorectal") -> PatchProto:
    p = proto_path(root, name, dataset)
    with np.load(p) as z:
        return PatchProto(
            name=name,
            features=z["features"],
            coords=z["coords"],
            label=int(z["label"]),
        )


def list_protos(root: str | Path, folds: list[str], dataset: str = "colorectal") -> list[str]:
    """All patch names under the given folds, sorted for determinism."""
    base = Path(root) / "proto" / "feature" / dataset
    names: list[str] = []
    for fold in folds:
        fold_dir = base / fold
        if not fold_dir.is_dir():
            continue
        for dirpath, _, files in os.walk(fold_dir):
            for f in sorted(files):
                if f.endswith(".npz"):
                    rel = Path(dirpath).relative_to(base) / f[: -len(".npz")]
                    names.append(str(rel))
    return sorted(names)
