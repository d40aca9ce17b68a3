"""PyTorch port, sharded checkpoints (``train/checkpoint_sharded.py``,
``torch.distributed.checkpoint`` over ``DTensor``s on the axis's own
group) as tests/test_checkpoint_sharded.py holds the orbax module, at
D = 2 gloo ranks on the CPU (``tests/torch_data_parallel_worker.py``):

- the same layout round-trips bit for bit, with its placements;
- a row-sharded state loads replicated at D = 2, and into plain tensors in
  one process (D = 1);
- a training state (model and Adam after one data-parallel step) saved at
  D = 2 and loaded in one process gives a next step equal to the unbroken
  run's: the loss at tests/test_torch_train.py's whole-step rule (atol
  2e-5, rtol 1e-4), the gradients at its ``GRAD_TOL``, the running
  statistics at atol 1e-5, rtol 1e-4. (Adam's updated values are not
  held: an update divides by the gradient's own magnitude, so a gradient
  that is rounding noise on both sides — the JK attention bias's — moves
  by a whole step either way.)
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.train import checkpoint_sharded as cs
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

import torch_data_parallel_worker as worker
from torch_port_util import example_batch, run_ranks

D = 2
TRAIN_OVER = ["model.hidden_dim=8", "model.embedding_dim=8",
              "model.assign_hidden_dim=8", "model.max_num_nodes=512",
              "model.drop_out=0.0", "train.optim=adam"]
LOSS_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
# seconds from the spawn to the last rank's exit (tests/torch_port_util.py's
# RankGroup): at least 3x the slowest the spawn took in a whole test run
RANKS_LIMIT = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    rng = np.random.default_rng(0)
    return {"x": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
            "w": rng.normal(size=24).astype(np.float32)}


@pytest.fixture(scope="module")
def batch():
    b = example_batch(batch=4, cap=256, seed=4)
    b["y"] = np.array([1, 0, 2, 1], np.int32)
    return b


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, batch):
    """D ranks saving and loading under ``root``; their results."""
    root = tmp_path_factory.mktemp("ckpt_sharded")
    out = root / "out"
    out.mkdir()
    job = [dict(name="sharded", kind="sharded", root=str(root), **_state(),
                train=dict(over=TRAIN_OVER, batch=batch))]
    torch.save(job, root / "job.pt")
    run_ranks(worker.run, (D, str(root / "init"), str(root / "job.pt"),
                           str(out)), D, root / "logs", RANKS_LIMIT)
    return root, [torch.load(out / f"rank{r}.pt", weights_only=False)
                  ["sharded"] for r in range(D)]


def test_save_restore_same_sharding(ranks):
    """Each rank reads back its own rows and the replicated leaves bit for
    bit, the placements kept; each rank wrote its own file."""
    _, res = ranks
    full, w = _state()["x"], _state()["w"]
    rows = full.shape[0] // D
    for r, got in enumerate(res):
        same = got["same"]
        np.testing.assert_array_equal(same["x"].numpy(),
                                      full[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(same["w"].numpy(), w)
        assert same["x_placements"] == [Shard(0)]
        assert same["w_placements"] == [Replicate()]
        assert same["step"] == 7
    assert sorted(f for f in res[0]["files"] if f.endswith(".distcp")) == \
        [f"__{r}_0.distcp" for r in range(D)]


def test_restore_resharded(ranks):
    """The row-sharded state restores onto another layout: replicated over
    the same ranks, and into plain tensors of one process."""
    root, res = ranks
    full, w = _state()["x"], _state()["w"]
    for got in res:
        np.testing.assert_array_equal(got["replicated"]["x"].numpy(), full)
        assert got["replicated"]["placements"] == [Replicate()]
    one = cs.load_sharded(root / "layout", {
        "x": torch.zeros(full.shape), "nested": {"w": torch.zeros(w.shape),
                                                 "step": torch.tensor(0)}})
    np.testing.assert_array_equal(one["x"].numpy(), full)
    np.testing.assert_array_equal(one["nested"]["w"].numpy(), w)
    assert int(one["nested"]["step"]) == 7


def test_restore_into_train_state(ranks, batch):
    """Model and Adam after one step at D = 2, loaded in one process: the
    state equals the saved one bit for bit, and the next step on the whole
    batch equals the unbroken D = 2 run's next step."""
    root, res = ranks
    saved, unbroken = res[0]["saved"], res[0]["train"]
    state = create_train_state(Config().apply_overrides(TRAIN_OVER), "cpu",
                               seed=5)
    cs.load_train_state(root / "train", state.model, state.optimizer)
    loaded = worker._flat(cs.train_state(state.model, state.optimizer))
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert torch.equal(loaded[k], v), k
        else:
            assert loaded[k] == v, k
    m = make_train_step()(state, worker.graph_of(batch))
    np.testing.assert_allclose(float(m["loss"]), unbroken["loss2"],
                               **LOSS_TOL)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   unbroken["grads"][n].numpy(), err_msg=n,
                                   **GRAD_TOL)
    for n, b in state.model.named_buffers():
        if "running" in n:
            np.testing.assert_allclose(b.numpy(),
                                       unbroken["buffers"][n].numpy(),
                                       err_msg=n, **STATS_TOL)
