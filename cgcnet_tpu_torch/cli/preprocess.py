"""Offline preprocessing CLI. Port of ``cgcnet_tpu/cli/preprocess.py``: the
same subcommands write the same protos and index files.

Stage A (reference construct_feature_graph.py): instance masks + images ->
per-nucleus feature/coordinate protos.
Stage B (reference prepare_cv_dataset.py): pre-sample fixed-epoch node
choices.

Usage:
    python -m cgcnet_tpu_torch.cli.preprocess features \
        --masks data/mask/colorectal --images data/images/colorectal \
        --out data [--processes 8]
    python -m cgcnet_tpu_torch.cli.preprocess fixed --root data \
        [data.sampling_method=fuse ...]
    python -m cgcnet_tpu_torch.cli.preprocess import-reference \
        --src /path/to/reference_data --dst data

import-reference reads the reference's on-disk artifacts — the
proto/{feature,coordinate}/<dataset>/... .npy trees
(construct_feature_graph.py:121-123) and/or torch-pickled PyG Data protos
(prepare_cv_dataset.py:107, dataflow/data.py:237,253) — so a
reference-layout directory trains end-to-end with zero manual conversion.

Mask files: <fold>/<grade_dir>/<patch>.npy int instance labels; images:
matching .png/.tif/.jpg under --images (read with OpenCV, which must then be
installed) or a .npy [H, W] uint8 grayscale image (numpy only). Images are
optional — without them, intensity features are zeroed and only geometry
is extracted. The features run on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from multiprocessing import Pool
from pathlib import Path

import numpy as np

from cgcnet_tpu_torch.dataflow.proto import LABEL_NAMES, PatchProto, save_proto
from cgcnet_tpu_torch.preprocess.features import extract_patch_features


def _label_from_path(rel: Path) -> int:
    for part in rel.parts:
        if part in LABEL_NAMES:
            return LABEL_NAMES[part]
    raise ValueError(f"no grade directory in {rel}")


def _read_gray(path: Path, shape: tuple[int, int]) -> np.ndarray:
    """A grayscale uint8 image of ``shape`` from ``path``: an image file
    through OpenCV (colour converted and resized as the JAX package does),
    or a .npy [H, W] uint8 array of that shape."""
    from cgcnet_tpu_torch.preprocess.features import cv2

    if path.suffix == ".npy":
        gray = np.load(path)
        if gray.dtype != np.uint8 or gray.shape != tuple(shape):
            raise ValueError(
                f"{path}: a .npy image must be uint8 {tuple(shape)}, got "
                f"{gray.dtype} {gray.shape}"
            )
        return gray
    if cv2 is None:
        raise ImportError(
            f"reading {path} needs OpenCV (the cv2 package), which is not "
            "installed: install it, or store the image as a .npy [H, W] "
            "uint8 grayscale array"
        )
    gray = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2GRAY)
    if gray.shape != tuple(shape):
        gray = cv2.resize(gray, tuple(shape)[::-1], interpolation=cv2.INTER_LINEAR)
    return gray


def _process_one(args) -> str:
    mask_path, image_root, out_root, mask_root = args
    rel = Path(mask_path).relative_to(mask_root).with_suffix("")
    mask = np.load(mask_path)
    gray = None
    if image_root:
        for ext in (".png", ".tif", ".jpg", ".npy"):
            cand = Path(image_root) / rel.parent / (rel.name + ext)
            if cand.exists():
                gray = _read_gray(cand, mask.shape)
                break
    if gray is None:
        gray = np.zeros(mask.shape, np.uint8)
    feats, coords = extract_patch_features(mask.astype(np.int64), gray)
    proto = PatchProto(
        name=str(rel), features=feats, coords=coords, label=_label_from_path(rel)
    )
    save_proto(out_root, proto)
    return str(rel)


def run_features(argv) -> int:
    p = argparse.ArgumentParser(prog="preprocess features")
    p.add_argument("--masks", required=True)
    p.add_argument("--images", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--processes", type=int, default=8)
    a = p.parse_args(argv)
    masks = sorted(Path(a.masks).rglob("*.npy"))
    if not masks:
        print(f"no .npy masks under {a.masks}", file=sys.stderr)
        return 1
    work = [(str(m), a.images, a.out, a.masks) for m in masks]
    if a.processes <= 1:
        done = [_process_one(w) for w in work]
    else:
        with Pool(a.processes) as pool:
            done = []
            for i, name in enumerate(pool.imap_unordered(_process_one, work)):
                done.append(name)
                if (i + 1) % 10 == 0:
                    print(f"Finish {i + 1}/{len(work)}")
    print(f"wrote {len(done)} protos under {a.out}/proto/feature")
    return 0


def run_fixed(argv) -> int:
    p = argparse.ArgumentParser(prog="preprocess fixed")
    p.add_argument("--root", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--processes", type=int, default=8)
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.dataflow.fixed_epochs import generate_fixed_epochs

    cfg = Config().apply_overrides(
        [f"data.root={a.root}"] + list(a.overrides)
    )
    names = generate_fixed_epochs(
        cfg.data, num_epochs=a.epochs, processes=a.processes
    )
    print(f"pre-sampled {len(names)} patches x {a.epochs or cfg.data.num_fixed_epochs} epochs")
    return 0


def _import_npy_tree(src: Path, dst: str, dataset: str) -> int:
    """proto/{feature,coordinate}/<dataset>/fold_*/... .npy pairs ->
    npz protos (reference construct_feature_graph.py:121-123 output layout,
    read back at prepare_cv_dataset.py:57-61)."""
    feat_root = src / "proto" / "feature" / dataset
    count = 0
    for fpath in sorted(feat_root.rglob("*.npy")):
        rel = fpath.relative_to(feat_root).with_suffix("")
        cpath = Path(str(fpath).replace("/feature/", "/coordinate/"))
        if not cpath.exists():
            print(f"skip {rel}: no coordinate file", file=sys.stderr)
            continue
        feats = np.load(fpath).astype(np.float32)
        coords = np.load(cpath).astype(np.float32)
        save_proto(
            dst,
            PatchProto(
                name=str(rel), features=feats, coords=coords,
                label=_label_from_path(rel),
            ),
            dataset,
        )
        count += 1
    return count


def _import_pt_tree(src: Path, dst: str, dataset: str) -> int:
    """torch-pickled PyG ``Data`` protos (x=[N,16|18], pos=[N,2], y) ->
    npz protos (reference layout written at prepare_cv_dataset.py:107 /
    read at dataflow/data.py:237,253). Point --src at one epoch directory of
    a fix_* tree (graphs there are pre-sampled: train with
    data.sample_ratio=1.0) or at any tree of raw Data pickles."""
    import torch

    count = 0
    for fpath in sorted(src.rglob("*.pt")):
        rel = fpath.relative_to(src).with_suffix("")
        data = torch.load(str(fpath), map_location="cpu", weights_only=False)
        x = np.asarray(data.x.numpy(), np.float32)
        coords = np.asarray(data.pos.numpy(), np.float32)
        if x.shape[1] == coords.shape[1] + 16:
            # reference raw protos append coords to x
            # (prepare_cv_dataset.py:61) — strip them back off
            x = x[:, : -coords.shape[1]]
        try:
            label = _label_from_path(rel)
        except ValueError:
            label = int(np.asarray(data.y).reshape(-1)[0])
        save_proto(
            dst,
            PatchProto(name=str(rel), features=x, coords=coords, label=label),
            dataset,
        )
        count += 1
    return count


def run_import(argv) -> int:
    p = argparse.ArgumentParser(
        prog="preprocess import-reference",
        description="Convert a reference-layout data tree (feature/coordinate "
        ".npy pairs, or torch .pt PyG Data pickles) into npz protos.",
    )
    p.add_argument("--src", required=True, help="reference data root (or .pt tree)")
    p.add_argument("--dst", required=True, help="output data root")
    p.add_argument("--dataset", default="colorectal")
    a = p.parse_args(argv)
    src = Path(a.src)
    n = 0
    if (src / "proto" / "feature" / a.dataset).is_dir():
        n += _import_npy_tree(src, a.dst, a.dataset)
    pts = any(src.rglob("*.pt"))
    if pts:
        n += _import_pt_tree(src, a.dst, a.dataset)
    if n == 0:
        print(
            f"nothing importable under {src} (expected proto/feature/"
            f"{a.dataset}/**.npy or **.pt)", file=sys.stderr,
        )
        return 1
    print(f"imported {n} protos -> {a.dst}/proto/feature/{a.dataset}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmds = {
        "features": run_features,
        "fixed": run_fixed,
        "import-reference": run_import,
    }
    if not argv or argv[0] not in cmds:
        print(__doc__)
        return 2
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
