"""Plain reference of the graph inputs: the sampled nuclei of a patch, the
radius graph and the normalized features, worked out again from the raw
nuclei the benchmark generated.

The rules are those the port's loader states (and CGC-Net's data pipeline
before it): the patch's sampling stream is keyed by (seed, patch, epoch,
purpose) through blake2b; ``fuse`` sampling takes ``int(0.7 * m)`` greedy
farthest points from a random start (squared distances in float32 formed
as the sampler forms them, ties to the first point of its grid order) and the rest uniformly without replacement from the
complement by a partial Fisher-Yates on a splitmix64 stream; the chosen
nuclei are band-sorted (floor(x / radius), then y, stable); each node keeps
itself and its nearest neighbours within the radius, up to ``k`` in all,
nearer first and the lower index on ties; features are z-scored in float32.

Plain PyTorch and NumPy: nothing of the program is imported.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def patch_rng(base_seed: int, name: str, epoch: int, purpose: str):
    key = f"{base_seed}|{name}|{epoch}|{purpose}".encode()
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))


def _splitmix(state: int):
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        yield z ^ (z >> 31)


def vector_lanes() -> int:
    """Lanes of the host's widest float vector (the sampler is built for
    its host: ``-march=native``): 16 with AVX-512, 8 with AVX2, else 1."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = f.read()
    except OSError:
        return 1
    return 16 if " avx512f" in flags else (8 if " avx2" in flags else 1)


def fps_grid(coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The sampler's grid: (order, cell) -- points binned into about 256 a
    cell over their bounding box in float32 arithmetic, listed cell by
    cell, then by index; ``cell`` of each point in that order."""
    n = len(coords)
    x, y = coords[:, 0], coords[:, 1]
    f32 = np.float32
    minx, miny = x.min(), y.min()
    w = max(f32(x.max() - minx), f32(1e-6))
    h = max(f32(y.max() - miny), f32(1e-6))
    target = max(1, n // 256)
    gx = max(1, int(np.floor(np.sqrt(float(target) * float(w) / float(h))
                             + 0.5)))
    gy = max(1, (target + gx - 1) // gx)
    cx = np.minimum(((x - minx) / w * f32(gx)).astype(np.int64), gx - 1)
    cy = np.minimum(((y - miny) / h * f32(gy)).astype(np.int64), gy - 1)
    cell = cx * gy + cy
    order = np.argsort(cell, kind="stable")
    return order, cell[order]


def fused_square_sum(a, b):
    """float32 a*a + b*b formed as one fused multiply-add, fma(a, a, b*b):
    a*a exact in float64, b*b rounded to float32, one rounding at the
    end."""
    return (a.double() * a.double() + (b * b).double()).float()


def farthest_points(coords: list, starts: list, counts: list,
                    device="cpu", lanes: int | None = None) -> list:
    """Greedy max-min sampling of several patches at once, ``counts[i]``
    points of patch i from ``starts[i]``, the first maximum in the
    sampler's grid order on ties. Squared distances in float32 as the
    sampler forms them: each grid cell's points in runs of ``lanes``
    vector lanes as fma(dy, dy, dx*dx), the cell's remaining points as
    fma(dx, dx, dy*dy) (the host compiler contracts each sum of products
    into one fused multiply-add, its operands ordered differently in the
    two loops)."""
    lanes = lanes or vector_lanes()
    b = len(coords)
    nmax = max(len(c) for c in coords)
    pts = torch.zeros(b, nmax, 2, dtype=torch.float32)
    pad = torch.ones(b, nmax, dtype=torch.bool)
    tail = torch.zeros(b, nmax, dtype=torch.bool)
    orders, first = [], []
    for i, c in enumerate(coords):
        order, cell = fps_grid(c)
        counts_c = np.bincount(cell)
        lane = np.arange(len(c)) - (np.cumsum(counts_c) - counts_c)[cell]
        tail[i, : len(c)] = torch.as_tensor(
            lane >= counts_c[cell] // lanes * lanes)
        pts[i, : len(c)] = torch.as_tensor(c[order])
        pad[i, : len(c)] = False
        orders.append(order)
        first.append(int(np.flatnonzero(order == starts[i])[0]))
    pts, pad, tail = pts.to(device), pad.to(device), tail.to(device)
    px, py = pts[..., 0], pts[..., 1]
    rows = torch.arange(b, device=device)
    best = torch.as_tensor(first, device=device)
    steps = max(counts)
    picks = torch.empty(b, steps, dtype=torch.long, device=device)
    running = None
    for s in range(steps):
        picks[:, s] = best
        dx = px - px[rows, best][:, None]
        dy = py - py[rows, best][:, None]
        d2 = torch.where(tail, fused_square_sum(dx, dy),
                         fused_square_sum(dy, dx))
        running = d2 if running is None else torch.minimum(running, d2)
        if s + 1 < steps:
            best = torch.argmax(running.masked_fill(pad, -1.0), dim=1)
    picks = picks.cpu().numpy()
    return [o[picks[i, : counts[i]]] for i, o in enumerate(orders)]


def fuse_sample(n: int, far: np.ndarray, num_sub: int, seed: int) -> np.ndarray:
    """``far`` followed by ``num_sub - len(far)`` uniform picks from the
    complement (partial Fisher-Yates on splitmix64 from ``seed``)."""
    chosen = np.zeros(n, bool)
    chosen[far] = True
    rem = np.flatnonzero(~chosen).tolist()
    need = min(num_sub - len(far), len(rem))
    stream = _splitmix(seed)
    picked = []
    for i in range(need):
        j = i + next(stream) % (len(rem) - i)
        rem[i], rem[j] = rem[j], rem[i]
        picked.append(rem[i])
    return np.concatenate([far.astype(np.int64), np.asarray(picked, np.int64)])


def band_sort(coords: np.ndarray, choice: np.ndarray, band: float) -> np.ndarray:
    b = np.floor(coords[choice, 0] / np.float32(band))
    order = np.lexsort((coords[choice, 1], b))   # stable on full ties
    return choice[order]


KNN_D2 = fused_square_sum


def radius_graph(coords: torch.Tensor, radius: float, k: int,
                 block: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """(nbr [n, k], mask [n, k]): itself first, then the nearest points
    within ``radius`` (d2 <= radius^2 in float32), the lower index on ties.
    A grid of cell size ``radius``; every cell's candidates padded to the
    fullest cell's count, in row blocks."""
    n = coords.shape[0]
    dev = coords.device
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    lo = coords.min(0).values
    cell = torch.floor((coords - lo) / radius).long()
    gy = int(cell[:, 1].max()) + 3
    cid = (cell[:, 0] + 1) * gy + (cell[:, 1] + 1)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    ncell = (int(cell[:, 0].max()) + 3) * gy
    counts = torch.bincount(sorted_cid, minlength=ncell)
    starts = torch.cumsum(counts, 0) - counts
    cmax = int(counts.max())
    nbr = torch.arange(n, device=dev)[:, None].repeat(1, k)
    mask = torch.zeros(n, k, device=dev)
    offs = torch.tensor([(dx * gy + dy) for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1)], device=dev)
    slot = torch.arange(cmax, device=dev)
    for b0 in range(0, n, block):
        rows = torch.arange(b0, min(n, b0 + block), device=dev)
        nc = cid[rows][:, None] + offs[None, :]                 # [r, 9]
        st, ct = starts[nc], counts[nc]
        pos = st[..., None] + slot                              # [r, 9, cmax]
        ok = slot < ct[..., None]
        cand = order[torch.where(ok, pos, 0)].reshape(len(rows), -1)
        ok = ok.reshape(len(rows), -1)
        dx = coords[cand, 0] - coords[rows, 0][:, None]
        dy = coords[cand, 1] - coords[rows, 1][:, None]
        d2 = KNN_D2(dx, dy)
        d2 = torch.where(cand == rows[:, None], torch.full_like(d2, -1.0), d2)
        ok &= d2 <= r2
        d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
        big = torch.where(ok, cand, torch.full_like(cand, n))
        # nearer first, the lower index on ties: by index, then stably by d2
        by_idx = torch.argsort(big, dim=1, stable=True)
        d2s = torch.gather(d2, 1, by_idx)
        by_d2 = torch.argsort(d2s, dim=1, stable=True)[:, :k]
        take = torch.gather(by_idx, 1, by_d2)
        sel = torch.gather(cand, 1, take)
        keep = torch.gather(ok, 1, take)
        if sel.shape[1] < k:
            pad = k - sel.shape[1]
            sel = torch.cat([sel, rows[:, None].repeat(1, pad)], 1)
            keep = torch.cat([keep, keep.new_zeros(len(rows), pad)], 1)
        nbr[rows] = torch.where(keep, sel, rows[:, None])
        mask[rows] = keep.float()
    return nbr, mask


def normalize(feats: np.ndarray, coords: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    x = np.concatenate([feats, coords], -1).astype(np.float32)
    return ((x - mean.astype(np.float32)) / std.astype(np.float32)).astype(
        np.float32)


def dataset_stats(arrays) -> tuple[np.ndarray, np.ndarray]:
    """Mean and std of every node's 18 features over a split, in float64."""
    allx = np.vstack([np.asarray(a, np.float64) for a in arrays])
    return allx.mean(0).astype(np.float32), allx.std(0).astype(np.float32)


def patch_graphs(patches: list, *, seed: int, epoch: int, purpose: str,
                 sample_ratio: float, far_fraction: float, radius: float,
                 k: int, capacity: int, mean, std, device="cpu") -> list:
    """Patches ``(name, feats, coords)`` as the model reads them: per patch
    x [m, 18], nbr / mask [m, k]."""
    plans = []
    for name, feats, coords in patches:
        n = len(coords)
        rng = patch_rng(seed, name, epoch, purpose)
        num_sub = min(int(n * sample_ratio), capacity)
        start = int(rng.integers(n))
        mix = int(rng.integers(np.iinfo(np.uint64).max, dtype=np.uint64))
        plans.append((num_sub, int(far_fraction * num_sub), start, mix))
    fars = farthest_points([p[2] for p in patches], [p[2] for p in plans],
                           [p[1] for p in plans], device)
    out = []
    for (name, feats, coords), (num_sub, _, _, mix), far in zip(
            patches, plans, fars):
        choice = band_sort(coords, fuse_sample(len(coords), far, num_sub, mix),
                           radius)
        c = torch.as_tensor(coords[choice], device=device)
        nbr, mask = radius_graph(c, radius, k)
        x = normalize(feats[choice], coords[choice], mean, std)
        out.append({"x": torch.as_tensor(x, device=device), "nbr": nbr,
                    "mask": mask})
    return out

