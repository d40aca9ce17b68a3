"""Typed configuration — single source of truth.

Replaces the reference's three uncoordinated config mechanisms (argparse with
~45 flags at train.py:299-411, hardcoded ``CrossValidSetting`` at setting.py:1-15,
and constants duplicated across dataflow files) with one dataclass tree that can
be loaded from / dumped to JSON and overridden from the command line.

Defaults reproduce the reference's canonical configuration
(parallel_train.sh:2-3 plus argparse defaults train.py:379-410 and
setting.py:15): hidden=20, output=20, assign_ratio=0.1, lr=1e-3, StepLR(10, 0.1),
sample_ratio=0.5, max 8 neighbours within 100px, 18-dim input features,
max_num_nodes=11404.

The fields, defaults and JSON layout are those of ``cgcnet_tpu.config``, so a
config file written by the JAX package loads here unchanged (fields that only
the JAX runtime reads, such as ``mesh``, are carried along untouched).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    """Architecture of the hierarchical encoder (reference model/network.py:127-291)."""

    input_dim: int = 18            # 16 appearance feats + 2 coords ('ca')
    hidden_dim: int = 20
    embedding_dim: int = 20
    assign_hidden_dim: int = 20
    num_classes: int = 3
    # assign_dim is derived from the *unsampled* max_num_nodes, matching the
    # reference quirk (train.py:254 passes setting.max_num_nodes=11404, so
    # pool-1 has int(11404*0.1)=1140 clusters and pool-2 int(1140*0.1)=114).
    max_num_nodes: int = 11404
    assign_ratio: float = 0.1
    pred_hidden_dims: tuple[int, ...] = (50,)
    gcn_name: str = "SAGE"         # 'SAGE' | 'GIN' | 'GAT' (dot-product
                                   # attention — TPU-build extension)
    gat_heads: int = 1             # attention heads (must divide the conv
                                   # width; GAT only)
    activation: str = "relu"       # 'relu' | 'elu' | 'leakyrelu'
    bias: bool = True
    bn: bool = True
    # Adaptive adjacency renormalization (--norm_adj): self-weight p=0.4
    # (reference model/network.py:183-191).
    norm_adj: bool = True
    self_weight: float = 0.4
    drop_out: float = 0.2
    jk: bool = True                # LSTM jumping knowledge (model/network.py:11-55)
    concat: bool = True
    # --- TPU-build extensions (not in the reference) ---
    # BN statistics over real nodes only. The reference computes BN over the
    # flattened [B*N, C] INCLUDING padded rows (model/network.py:101-107);
    # set False to reproduce that quirk bit-for-bit for parity tests.
    masked_bn: bool = True
    # Max readout with -inf masking of padded rows. The reference's implicit
    # zero-padding readout (model/network.py:264) is reproduced when False.
    masked_readout: bool = True
    # Numerics: 'float32' everywhere, or 'bfloat16' matmul inputs w/ f32 accum.
    compute_dtype: str = "float32"
    # Block-sparse stage-1 aggregation (the field keeps the JAX package's
    # name so one config JSON drives both packages). In this package
    # 'auto' and 'always' run the BSR path: the hand-written CUDA kernels
    # when the batch lies on a CUDA device, their plain PyTorch versions
    # when it lies on the CPU. 'never' asks for the gather path, which
    # this package does not have yet (the model raises).
    use_pallas: str | bool = "auto"
    # Fold the pooling blocks' bn3 affine into the concat-lin kernel
    # (nn/blocks.py::GNNBlock.finish_folded): the 1140-wide assign head never
    # materializes its BN output or concat. Identical math up to fp
    # reassociation; set False to run the literal reference op order.
    fold_assign_tail: bool = True
    # Fuse the stage-1 assign tail (folded-lin matmul + softmax + mask) into
    # one Pallas pass emitting S in both consumer layouts
    # (ops/pallas/assign_head.py). 'auto' = whenever the Pallas BSR path is
    # active and the node capacity tiles by 128; 'always' forces it (CPU
    # tests use interpret mode); 'never' disables. Requires fold_assign_tail.
    fused_assign_softmax: str | bool = "auto"
    # Deeper fusion of the same tail: conv3's L2-normalize + relu + BN
    # statistics also move into the Pallas passes, so conv3's activation
    # tensor never reaches HBM (nn/blocks.py::finish_folded_pre). 'auto' =
    # whenever the fused softmax is active and the conv is SAGE+relu;
    # 'always' / 'never' force. BN batch variance is computed single-pass
    # from (sum, sum-of-squares) — identical up to f32 rounding.
    fused_assign_norm: str | bool = "auto"
    # Slide-capacity path: recompute the fused assign tail's backward in row
    # chunks of this many nodes (0 = off). Bounds the backward working set
    # to O(chunk * assign_dim) instead of ~7 concurrent [N, assign_dim]
    # tensors — the measured 1M-nuclei single-chip OOM
    # (benchmarks/slide_scale_r3.json). A target value, snapped to a legal
    # multiple of 128 at trace time (non-dividing chunks get one remainder
    # chunk); costs ~2 extra fused-forward passes.
    assign_tail_chunk: int = 0

    @property
    def assign_dims(self) -> tuple[int, int]:
        d1 = int(self.max_num_nodes * self.assign_ratio)
        d2 = int(d1 * self.assign_ratio)
        return d1, d2

    @property
    def stage_input_dims(self) -> tuple[int, int, int]:
        """Input feature dim at each of the 3 stages (model/network.py:150-153).

        Matches what nn/model.py actually feeds each stage: the pooled
        embedding of the previous stage — DenseJK's [B, N, hidden] when jk
        is on, else the block's 3-layer concat (GNNBlock.finish always
        concatenates, like the reference's canonical concat=1)."""
        if self.jk:
            inner = self.hidden_dim
        else:
            inner = self.hidden_dim * 2 + self.embedding_dim
        return self.input_dim, inner, inner

    @property
    def pred_input_dim(self) -> int:
        return self.stage_input_dims[1] * 3


@dataclass
class DataConfig:
    """Dataflow / sampling (reference dataflow/data.py, setting.py)."""

    root: str = "data"
    dataset: str = "colorectal"
    feature_type: str = "ca"       # 'c' coords | 'a' appearance | 'ca' both
    cross_val: int = 1             # fold selection (dataflow/data.py:15-19)
    sample_ratio: float = 0.5
    sampling_method: str = "fuse"  # 'farthest' | 'fuse' | 'random'
    fuse_far_fraction: float = 0.7  # fuse = 70% FPS + 30% random (data.py:211-219)
    graph_sampler: str = "knn"     # 'knn' | 'random'
    max_edge_distance: float = 100.0
    max_neighbours: int = 8
    # torch-cluster compat: take the FIRST k in index order within the radius
    # instead of the k nearest (reference radius_graph behaviour — see
    # ops/knn.py). Default nearest-k (strictly better, still deterministic).
    knn_scan_order: bool = False
    max_num_nodes: int = 11404     # dataset-wide max node count (setting.py:15)
    # NOTE: the reference's --dynamic_graph flag has no analog here — because
    # sampling is a pure function of (seed, patch, epoch), per-epoch
    # resampling is the default behaviour and the pre-baked protocol is just
    # `use_fixed` below.
    num_fixed_epochs: int = 30     # offline pre-sampled epoch count (prepare_cv_dataset.py:79)
    # Replay offline pre-sampled node choices (dataflow/fixed_epochs.py)
    # instead of sampling in the loader; epochs wrap modulo num_fixed_epochs.
    use_fixed: bool = False
    # Evaluate on the full, unsampled graph of every patch at batch size 1
    # (reference NucleiDatasetTest, dataflow/data.py:281-316). Training still
    # subsamples; only val/test loaders switch to full graphs.
    full_test_graph: bool = False
    # Pad each batch to a power-of-two node bucket instead of the full
    # dataset capacity (fewer wasted FLOPs on small patches; a handful of
    # extra jit shapes). Off = reference-style fixed capacity.
    dynamic_buckets: bool = False
    # Sort sampled nuclei into spatial bands (y-band then x) so the radius
    # graph is band-limited — required by the block-sparse Pallas kernel and
    # harmless otherwise (GNN output is node-permutation invariant).
    spatial_sort: bool = True
    # Ceiling on BSR blocks-per-row-tile (0 disables metadata; the model then
    # uses XLA gathers). The loader picks the smallest quantized capacity
    # that fits each batch — kernel cost scales with it — and falls back to
    # gathers with a warning past this ceiling.
    bsr_blocks: int = 16
    batch_size: int = 4
    # 0 = auto (one worker per host core). The native build_patch path is
    # GIL-free, so loader throughput scales with cores until it covers the
    # chip's consumption (~420 patches/s needs ~7 cores at 4.3 ms/patch).
    num_workers: int = 0
    prefetch: int = 2
    # Keep loaded protos in RAM (a full CRC fold is ~1.4 GB; removes npz
    # parse cost from the per-epoch hot loop). Disable for huge datasets.
    cache_protos: bool = True
    # Steady-state built-graph cache budget (MB). When sample content is
    # epoch-PERIODIC — fixed-epoch mode wraps at epoch % num_fixed_epochs
    # (the reference's 30 pre-baked epochs, prepare_cv_dataset.py:75-109),
    # and full-graph kNN datasets never consume the RNG — revisits reuse the
    # built graph (sampling/kNN/transpose/normalize all skipped), so from
    # epoch num_fixed_epochs+1 on, loading costs one memcpy per patch.
    # Inserts stop at the budget (no eviction — access is cyclic). 0 = off.
    # Dynamic per-epoch sampling (the default) is unaffected: its content is
    # epoch-unique by design and is never cached.
    graph_cache_mb: int = 1024
    # Small graphs are kept whole: patches under this node count are not
    # subsampled (reference dataflow/data.py:199-201, colon task excluded there;
    # we keep the guard unconditionally — it only helps).
    min_nodes_no_subsample: int = 100
    normalize_coords_by: float = 3584.0   # tile size (construct_feature_graph.py:15)
    seed: int = 1024

    @property
    def padded_nodes(self) -> int:
        """Static per-patch node capacity: int(11404*0.5)+1 = 5703 (data.py:133)."""
        return int(self.max_num_nodes * self.sample_ratio) + 1

    @property
    def num_features(self) -> int:
        return {"c": 2, "a": 16, "ca": 18}[self.feature_type]


@dataclass
class TrainConfig:
    """Optimization & loop control (reference train.py:138-244, common/utils.py:119-127)."""

    optim: str = "adam"            # 'adam' | 'sgd' | 'rmsprop'
    lr: float = 1e-3
    weight_decay: float = 1e-4     # L2-into-grad like torch (not decoupled)
    momentum: float = 0.9
    step_size: int = 10            # StepLR epochs (parallel_train.sh uses 10)
    gamma: float = 0.1
    num_epochs: int = 30
    test_epoch: int = 5            # test-time multi-sampling repeats (train.py:27)
    eval_every_batches: int = 88   # mid-epoch val cadence (~train_iter 3500/40, train.py:176,185)
    # Image-level voting: one vote per patch per test-time repeat, like the
    # reference (train.py:32-57); False = vote once on repeat-mean logits.
    vote_per_repeat: bool = True
    # Truncate each eval repeat after this many examples (reference
    # max_num_examples, train.py:60-62); 0 = no truncation.
    eval_max_examples: int = 0
    ckpt_dir: str = "runs"
    run_name: str = ""
    resume: str = ""               # '' | 'best' | 'weight' | explicit path
    seed: int = 0
    log_every: int = 10
    # Run the optimizer on one flat concatenated vector (optax.flatten):
    # numerically identical for elementwise transforms (adam/sgd/rmsprop/
    # decay all are), but ~100 tiny per-leaf update fusions collapse into a
    # few wide ones — measured ~0.4 ms/step at the canonical model size.
    flatten_opt: bool = True
    profile: bool = False
    tensorboard: bool = False      # also mirror metrics to TB event files
    debug_nans: bool = False       # jax_debug_nans for fault isolation


@dataclass
class MeshConfig:
    """Device mesh for pjit/shard_map (TPU-build extension; reference has only
    single-process DataParallel, train.py:276-287)."""

    data_axis: int = 0             # 0 = use all devices on 'data'
    graph_axis: int = 1            # edge-partition axis for mega-graphs
    # capacity of the per-shard halo (boundary node) buffer, as a fraction of
    # the shard's node count; static shape for all_to_all.
    halo_capacity: float = 0.25
    # Split stage-1 aggregation into interior (collective-independent) and
    # boundary parts so XLA overlaps the halo all_to_all with interior
    # compute. Pays on real ICI; neutral on a virtual CPU mesh.
    halo_overlap: bool = True
    # Rematerialize the pool-1 assignment segment in the slide backward
    # (jax.checkpoint): the [Ns, 1140]-class tensors (assign logits, S, A@S)
    # are recomputed instead of stored, trading ~one extra pool-1 forward
    # for the dominant activation memory at 1M-nuclei scale.
    remat: bool = False
    # Rematerialize the paired stage-1 (embed1, pool1) layers 1-3 + JK in
    # the slide backward: the [Ns, <=120] dual-stream activations and their
    # backward intermediates (~2.8 GB at 1M nuclei) must otherwise survive
    # the pool-1 backward peak. Costs ~3 extra F<=40 matvec legs per step.
    remat_stage1: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {tp.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply 'section.key=value' CLI overrides; value parsed as JSON else str."""
        d = self.to_dict()
        for ov in overrides:
            key, _, val = ov.partition("=")
            parts = key.split(".")
            try:
                pyval = json.loads(val)
            except (json.JSONDecodeError, ValueError):
                pyval = val
            cur = d
            for p in parts[:-1]:
                cur = cur[p]
            if parts[-1] not in cur:
                raise KeyError(f"unknown config key {key}")
            cur[parts[-1]] = pyval
        return Config.from_dict(d)

    def run_id(self) -> str:
        """Stable short hash of the experiment-defining config — names the
        run directory.

        Replaces the reference's 20-hyperparameter gen_prefix string codec
        (train.py:93-135) whose paths orphan checkpoints on any flag change.
        Volatile fields that don't define the experiment (resume mode,
        checkpoint root, epoch budget, logging cadence) are excluded so e.g.
        ``train.resume=best`` resolves to the same run directory it resumes.
        """
        d = self.to_dict()
        for k in ("resume", "ckpt_dir", "num_epochs", "log_every", "profile"):
            d["train"].pop(k, None)
        blob = json.dumps(d, indent=2, sort_keys=True)
        h = hashlib.sha256(blob.encode()).hexdigest()[:10]
        name = self.train.run_name or f"cgc_{self.model.gcn_name.lower()}"
        return f"{name}_{h}"
