"""PyTorch port, ``assign_tail_train_chunked`` (``ops/assign_head.py``): the
training tail (B3, the tail algebra, B4) whose backward recomputes S chunk
by chunk and launches B5 on each chunk, against the JAX package's
``assign_tail_train_chunked`` (``cgcnet_tpu/ops/pallas/assign_head.py``,
Pallas in interpret mode, jitted) at its own tests' shapes
(tests/test_assign_head.py: one graph of 512 rows, C = 36, F12 = 8, a
prefix mask of 400 rows): on one rank with chunks of 128 (four full
chunks) and 384 (one full chunk and a 128-row remainder), against the
port's unchunked ``AssignTailTrain``, and as two gloo ranks (256 rows
each; tests/torch_multishard_worker.py's ``tail_case``) with the
statistics summed over the axis against JAX's 2-device ``shard_map``.

Tolerances are the JAX suite's (tests/test_assign_head.py): S, mean and
var within 1e-6 (the same kernels' arithmetic; B4 at f32 rounds S as the
Pallas kernel does), and the gradients at atol 5e-5 / rtol 1e-4 (the f32
[C]-sized sums taken chunk by chunk, in another order). The gradients in
the mask and the real-row count are JAX's exact zeros; the port gives
none.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import cgcnet_tpu.ops.pallas.assign_head as jah
from cgcnet_tpu_torch.ops import assign_head as tah

import torch_multishard_worker as worker
from torch_port_util import RankGroup

B, N, C, F12, REAL = 1, 512, 36, 8, 400
CHUNKS = (128, 384)
C_OUT = 128  # S lane-padded as the slide path's tail emits it
NAMES = ("x12", "p", "k12", "k3", "lb", "sc", "bi")
FWD_TOL = dict(atol=1e-6, rtol=0.0)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
# seconds from the spawn to the last rank's exit (tests/torch_port_util.py's
# RankGroup): at least 3x the slowest the spawn took in a whole test run
RANKS_LIMIT = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode():
    jah.set_interpret(True)
    yield
    jah.set_interpret(False)


def tail_inputs(seed=0) -> dict:
    """The tail's operands and the cotangents of S and S^T (numpy)."""
    rng = np.random.default_rng(seed)
    g = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(x12=g(B, N, F12), p=g(B, N, C), k12=g(F12, C),
                k3=g(C, C, sc=0.2), lb=g(C), sc=1.0 + g(C, sc=0.2),
                bi=g(C, sc=0.1), ds=g(B, N, C), ds_t=g(B, C, N),
                ds_pad=g(B, N, C_OUT - C))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks of ``tail_case``, started before the JAX side
    compiles; their results (one dict a rank) on first use."""
    root = tmp_path_factory.mktemp("chunked_tail")
    (root / "out").mkdir()
    job = [dict(name="tail", kind="tail", n_real=REAL, chunks=CHUNKS,
                **tail_inputs())]
    torch.save(job, root / "job.pt")
    group = RankGroup(
        worker.run, (2, str(root / "init"), str(root / "job.pt"),
                     str(root / "out")),
        2, root / "logs", limit=RANKS_LIMIT)
    res = []

    def results():
        if not res:
            group.join()
            res.extend(torch.load(root / "out" / f"rank{r}.pt",
                                  weights_only=False)["tail"]
                       for r in range(2))
        return res

    yield results
    group.close()


def _mask():
    return jnp.asarray((np.arange(N) < REAL)[None], jnp.float32)


def _jax_loss(fn, h):
    """sum(S * ds) + sum(S^T * ds_t) of ``fn(x12, p, k12, k3, lb, sc, bi,
    mask, n)`` -> (S, S^T, mean, var), with the outputs."""
    def loss(*v):
        s, s_t, mean, var = fn(*v)
        return (jnp.sum(s * h["ds"]) + jnp.sum(s_t * h["ds_t"]),
                (s, mean, var))
    return loss


def _jax_single(h):
    """JAX's one-device results at each chunk: {chunk: (S, mean, var,
    nine gradients)} — one jitted program."""
    args = [jnp.asarray(h[k]) for k in NAMES] + [_mask(), jnp.float32(REAL)]

    def both(*v):
        out = {}
        for ch in CHUNKS:
            fn = lambda *a, ch=ch: jah.assign_tail_train_chunked(
                *a, 1e-5, None, ch)
            (_, aux), grads = jax.value_and_grad(
                _jax_loss(fn, h), argnums=tuple(range(9)), has_aux=True)(*v)
            out[ch] = (*aux, grads)
        return out

    return jax.jit(both)(*args)


def _jax_sharded(h):
    """JAX's 2-device ``shard_map`` results at each chunk, the statistics
    psummed over 'graph' (tests/test_assign_head.py's
    ``test_chunked_tail_psum_matches_single_device``)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("graph",))
    rows, rep = P(None, "graph"), P()
    args = [jnp.asarray(h[k]) for k in NAMES] + [_mask(), jnp.float32(REAL)]

    def both(*v):
        out = {}
        for ch in CHUNKS:
            fn = jax.shard_map(
                lambda *a, ch=ch: jah.assign_tail_train_chunked(
                    *a, 1e-5, "graph", ch),
                mesh=mesh,
                in_specs=(rows, rows) + (rep,) * 5 + (rows, rep),
                out_specs=(rows, P(None, None, "graph"), rep, rep),
                check_vma=False)
            (_, aux), grads = jax.value_and_grad(
                _jax_loss(fn, h), argnums=tuple(range(9)), has_aux=True)(*v)
            out[ch] = (*aux, grads)
        return out

    return jax.jit(both)(*args)


def _port(h, chunk, fn="chunked", c_out=None):
    """The port's (S, mean, var, gradients in NAMES and n) on one rank;
    ``fn`` "chunked", "unchunked" (``AssignTailTrain``) or "psum"
    (``assign_tail_train_psum``, with ``c_out``)."""
    v = [torch.tensor(h[k], requires_grad=True) for k in NAMES]
    n = torch.tensor(float(REAL), requires_grad=True)
    n_nodes = torch.tensor([REAL], dtype=torch.int32)
    if fn == "chunked":
        s, mean, var = tah.assign_tail_train_chunked(
            *v, n_nodes, n, 1e-5, c_out=c_out, chunk_rows=chunk)
    elif fn == "psum":
        s, mean, var = tah.assign_tail_train_psum(*v, n_nodes, n, 1e-5,
                                                  c_out=c_out)
    else:
        s, mean, var = tah.AssignTailTrain.apply(*v, n_nodes, n, 1e-5)
    ds, ds_t = h["ds"], h["ds_t"]
    if c_out is not None:  # cotangents on the pad columns too
        ds = np.concatenate([ds, h["ds_pad"]], axis=-1)
        ds_t = np.concatenate([ds_t, h["ds_pad"].transpose(0, 2, 1)],
                              axis=1)
    loss = (s * torch.tensor(ds)).sum() + (
        s.transpose(1, 2) * torch.tensor(ds_t)).sum()
    grads = torch.autograd.grad(loss, v + [n], allow_unused=True)
    return s.detach(), mean, var, grads


def _np(t):
    return t.detach().float().numpy()


def _hold(s, mean, var, grads, ref):
    """The port's results against JAX's (S, mean, var, nine gradients):
    seven at GRAD_TOL, the mask's and n's zero in JAX and none in the
    port."""
    s_j, mean_j, var_j, g_j = ref
    np.testing.assert_allclose(s, np.asarray(s_j), **FWD_TOL)
    np.testing.assert_allclose(mean, np.asarray(mean_j), **FWD_TOL)
    np.testing.assert_allclose(var, np.asarray(var_j), **FWD_TOL)
    for name, gt, gj in zip(NAMES, grads, g_j):
        np.testing.assert_allclose(gt, np.asarray(gj), **GRAD_TOL,
                                   err_msg=name)
    assert not np.asarray(g_j[7]).any() and float(g_j[8]) == 0.0
    assert grads[7] is None


_JAX: dict = {}


def jax_ref(kind):
    if kind not in _JAX:
        _JAX[kind] = (_jax_single if kind == "single" else _jax_sharded)(
            tail_inputs())
    return _JAX[kind]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_tail_matches_jax(ranks, chunk):
    """One rank: S, mean, var and all nine gradients against JAX's at the
    same chunk (128: four full chunks; 384: one and a 128-row
    remainder)."""
    ch, nfull, rem = tah.chunk_plan(N, chunk)
    assert (ch, nfull, rem) == ((128, 4, 0) if chunk == 128
                                else (384, 1, 128))
    s, mean, var, grads = _port(tail_inputs(), chunk)
    _hold(_np(s), _np(mean), _np(var),
          [None if g is None else _np(g) for g in grads],
          jax_ref("single")[chunk])


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_tail_matches_unchunked(chunk):
    """The same function as the port's ``AssignTailTrain``: the forward
    the same bits (the same B3 and B4), the gradients at GRAD_TOL."""
    h = tail_inputs()
    got, want = _port(h, chunk), _port(h, chunk, fn="unchunked")
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for name, a, b in zip(NAMES + ("n",), got[3], want[3]):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL, err_msg=name)


def test_chunked_tail_psum_matches_jax_shard_map(ranks):
    """Two gloo ranks of 256 rows (chunks of 128, and 384 taken as the
    rank's 256 rows), the statistics summed over the axis, against JAX's
    2-device shard_map: S row by row, mean and var on each rank, the row
    gradients (x12, p) by rank, the parameters' summed over the ranks
    (each rank's share; ``parallel/mega_train.reduce_grads``'s sum)."""
    ref = jax_ref("sharded")
    res = ranks()
    ns = N // 2
    for chunk in CHUNKS:
        parts = [r[chunk] for r in res]
        grads = [np.concatenate([p_["grads"][i] for p_ in parts], axis=1)
                 for i in range(2)]
        grads += [sum(p_["grads"][i] for p_ in parts) for i in range(2, 7)]
        grads.append(None)  # n: the port gives none on either rank
        assert all(p_["grads"][7] is None for p_ in parts)
        for r, p_ in enumerate(parts):
            np.testing.assert_array_equal(p_["mean"], parts[0]["mean"])
            np.testing.assert_array_equal(p_["var"], parts[0]["var"])
            np.testing.assert_allclose(
                p_["s"], np.asarray(ref[chunk][0])[:, r * ns:(r + 1) * ns],
                **FWD_TOL)
        _hold(np.concatenate([p_["s"] for p_ in parts], axis=1),
              parts[0]["mean"], parts[0]["var"], grads, ref[chunk])


def test_chunked_tail_c_out_matches_psum_tail():
    """With ``c_out`` (S 128 columns wide, the pad columns exact zeros and
    their cotangents ignored): the same function as the port's unchunked
    ``assign_tail_train_psum`` at the same width (held against JAX's by
    tests/test_torch_slide_kernels.py): the forward the same bits, the
    gradients at GRAD_TOL, in chunks of 128."""
    h = tail_inputs()
    got = _port(h, 128, c_out=C_OUT)
    want = _port(h, 128, fn="psum", c_out=C_OUT)
    assert got[0].shape == (B, N, C_OUT) and not got[0][..., C:].any()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for name, a, b in zip(NAMES, got[3], want[3]):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL, err_msg=name)
