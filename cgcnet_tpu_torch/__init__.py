"""cgcnet_tpu_torch — the PyTorch/CUDA port of cgcnet_tpu.

The same cell-graph classifier (CGC-Net: adaptive GraphSAGE, DiffPool,
LSTM jumping knowledge, image-level voting) in PyTorch, with every kernel
that the JAX package wrote in Pallas for the TPU rewritten by hand in CUDA
C++ for Hopper (``csrc/``), each beside a plain PyTorch version of the same
function that the CPU path runs. The JAX package stays the reference; this
package imports nothing from it.

Ported so far: the serving path (``cli/predict.py``: dataset, loader, eval
forward of the canonical SAGE/JK/norm_adj model, image-level metric), the
training path (``cli/train.py``: training-mode forward and backward, torch
optimizers with StepLR, ``Trainer`` with validation, checkpoints, resume),
every model option of the patch path (GIN, GAT, the gather path) and the
whole-slide path at one or more shards (``cli/slide.py``, ``parallel/``:
serving, fine-tuning and the chunked capacity tail of an unsampled slide),
and the remaining entry points and host code: ``cli/export.py``
(``torch.export``, the kernels as custom ops), ``cli/crossval.py``,
``cli/preprocess.py``, GEXF dumps, profiling, the random and fixed-epoch
samplers and dynamic buckets.
"""

from cgcnet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from cgcnet_tpu_torch.core.graph import CellGraph

__all__ = ["Config", "DataConfig", "ModelConfig", "TrainConfig", "CellGraph"]
