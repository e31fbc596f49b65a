"""Port parity: the facade's bridges and persistence against the JAX
package: the cases of ``tests/test_convert.py`` (the scipy bridge, and
``torch.sparse`` where the JAX package bridges to ``jax.experimental.sparse``),
``save_npz``/``load_npz`` across the two packages in both directions,
``to_state_dict``/``from_state_dict`` of a ``PaddedCOO`` across them,
``sparse_tensor_from_jax`` (array for array, cached fields and their
presence kept), ``random.seed`` and the test grid of ``testing``.

Tolerances: every comparison is exact (conversions copy values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu import io as jio
from paddle_sparse_tpu_torch import io as tio
from paddle_sparse_tpu_torch import random as trandom
from paddle_sparse_tpu_torch import testing as ttesting

FIELDS = ("row", "rowptr", "col", "value", "rowcount", "colptr", "colcount",
          "csr2csc", "csc2csr")
DENSE = np.asarray([[0, 1.0, 0], [2, 0, 3], [0, 0, 4]], np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.double() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float64) if jnp.issubdtype(a.dtype, jnp.floating) \
        else a


def _same(t, j):
    if t is None or j is None:
        assert t is None and j is None
        return
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def _same_tensor(T, J):
    assert T.sizes() == J.sizes()
    assert T.storage.cached_keys() == J.storage.cached_keys()
    for name in FIELDS:
        _same(getattr(T.storage, f"_{name}"), getattr(J.storage, f"_{name}"))


def _rand(seed, M=12, N=9, nnz=40, trailing=(), value=True):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, M, nnz), rng.integers(0, N, nnz)
    row, col = np.concatenate([row, row[:5]]), np.concatenate([col, col[:5]])
    val = (rng.standard_normal((len(row),) + trailing).astype(np.float32)
           if value else None)
    J = jsp.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=(M, N))
    T = tsp.SparseTensor(row=torch.from_numpy(row), col=torch.from_numpy(col),
                         value=None if val is None else torch.from_numpy(val),
                         sparse_sizes=(M, N))
    return T, J


CASES = {"plain": dict(seed=0), "trailing": dict(seed=1, trailing=(3,)),
         "no_value": dict(seed=2, value=False), "nnz0": dict(seed=3, nnz=0)}


# ---------------------------------------------------------------------------
# the cases of tests/test_convert.py
# ---------------------------------------------------------------------------
def test_convert_scipy():
    index = np.asarray([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = np.asarray([1, 2, 4, 1, 3])
    out = tsp.from_scipy(tsp.to_scipy(torch.from_numpy(index),
                                      torch.from_numpy(value), 3, 3))
    assert out[0].tolist() == index.tolist()
    assert out[1].tolist() == value.tolist()
    jout = jsp.from_scipy(jsp.to_scipy(jnp.asarray(index), jnp.asarray(value),
                                       3, 3))
    _same(out[0], jout[0])
    _same(out[1], jout[1])


def test_convert_torch_sparse():
    index = np.asarray([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = np.asarray([1, 2, 4, 1, 3])
    A = tsp.to_torch_sparse(torch.from_numpy(index), torch.from_numpy(value),
                            3, 3)
    assert A.layout == torch.sparse_coo and A.shape == (3, 3)
    out = tsp.from_torch_sparse(A.coalesce())
    assert out[0].tolist() == index.tolist()
    assert out[1].tolist() == value.tolist()
    assert tsp.to_paddle_sparse is tsp.to_torch_sparse
    assert tsp.from_paddle_sparse is tsp.from_torch_sparse
    jout = jsp.from_jax_sparse(jsp.to_jax_sparse(
        jnp.asarray(index), jnp.asarray(value), 3, 3).sum_duplicates())
    _same(out[0], jout[0])
    _same(out[1], jout[1])
    dup = np.concatenate([index, index[:, :2]], axis=1)
    A = tsp.to_torch_sparse(dup, np.arange(7.0), 3, 3)
    assert tsp.from_torch_sparse(A)[0].shape == (2, 7)   # kept as stored


def test_tensor_scipy_roundtrip():
    T = tsp.SparseTensor.from_dense(DENSE)
    J = jsp.SparseTensor.from_dense(jnp.asarray(DENSE))
    for layout in ("coo", "csr", "csc"):
        sp = T.to_scipy(layout=layout)
        np.testing.assert_array_equal(sp.toarray(), DENSE)
        assert type(sp) is type(J.to_scipy(layout=layout))
        back = tsp.SparseTensor.from_scipy(sp)
        np.testing.assert_array_equal(back.to_dense().numpy(), DENSE)
        _same_tensor(back, jsp.SparseTensor.from_scipy(sp))
    sp = T.set_value(None).to_scipy(layout="csr", dtype=np.float64)
    assert sp.dtype == np.float64
    assert not tsp.SparseTensor.from_scipy(sp, has_value=False).has_value()
    with pytest.raises(ValueError, match="2-D"):
        T.set_value(torch.ones(4, 2), layout="coo").to_scipy(layout="coo")


def test_tensor_torch_sparse_roundtrip():
    """``to/from_torch_sparse_coo_tensor`` and ``_csr_tensor`` (and the
    reference's ``paddle`` names for them), where the JAX package maps these
    onto BCOO/BCSR."""
    T = tsp.SparseTensor.from_dense(DENSE)
    for to, frm in (("coo", "coo"), ("csr", "csr")):
        sp = getattr(T, f"to_torch_sparse_{to}_tensor")()
        np.testing.assert_array_equal(sp.to_dense().numpy(), DENSE)
        back = getattr(tsp.SparseTensor, f"from_torch_sparse_{frm}_tensor")(sp)
        assert back == T
        sp = getattr(T, f"to_paddle_sparse_{to}_tensor")(torch.float64)
        assert sp.dtype == torch.float64
        back = getattr(tsp.SparseTensor, f"from_paddle_sparse_{frm}_tensor")(
            sp)
        np.testing.assert_array_equal(back.to_dense().numpy(), DENSE)
    bcoo = jsp.SparseTensor.from_dense(jnp.asarray(DENSE)).to_jax_bcoo()
    np.testing.assert_array_equal(
        T.to_torch_sparse_coo_tensor().to_dense().numpy(),
        np.asarray(bcoo.todense()))
    S = T.set_value(None)
    assert S.to_torch_sparse_csr_tensor().values().tolist() == [1.0] * 4
    assert not tsp.SparseTensor.from_torch_sparse_coo_tensor(
        T.to_torch_sparse_coo_tensor(), has_value=False).has_value()
    with pytest.raises(NotImplementedError):
        T.to_paddle_sparse_csc_tensor()


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_scipy_random(case):
    T, J = _rand(**CASES[case])
    _same(T.to_dense(), J.to_dense())
    if T.dim() != 2:
        with pytest.raises(ValueError, match="2-D"):
            T.to_scipy(layout="coo")
        return
    for layout in ("coo", "csr", "csc"):
        sp, jsp_ = T.to_scipy(layout=layout), J.to_scipy(layout=layout)
        np.testing.assert_array_equal(sp.toarray(), jsp_.toarray())
        _same_tensor(tsp.SparseTensor.from_scipy(sp),
                     jsp.SparseTensor.from_scipy(sp))


# ---------------------------------------------------------------------------
# persistence across the two packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_npz_across_packages(case, tmp_path):
    T, J = _rand(**CASES[case])
    T.save_npz(str(tmp_path / "t.npz"))
    jio.save_npz(str(tmp_path / "j.npz"), J)
    # the JAX method passes the tensor as the path (a reference fault)
    with pytest.raises(AttributeError):
        J.save_npz(str(tmp_path / "j2.npz"))
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    _same_tensor(tsp.load_npz(str(tmp_path / "j.npz")),
                 jsp.load_npz(str(tmp_path / "t.npz")))
    back = tsp.SparseTensor.load_npz(str(tmp_path / "t.npz"), device="cpu")
    assert back == T


@pytest.mark.parametrize("value", [True, False])
def test_state_dict_across_packages(value):
    T, J = _rand(seed=5, value=value)
    P = T.to_padded(capacity=T.nnz() + 5)
    JP = J.to_padded(capacity=J.nnz() + 5)
    ts, js = tio.to_state_dict(P), jio.to_state_dict(JP)
    assert sorted(ts) == sorted(js)
    for k in ts:
        np.testing.assert_array_equal(ts[k], js[k])
    back = tio.from_state_dict(js)
    jback = jio.from_state_dict(ts)
    for name in ("row", "col", "value"):
        _same(getattr(back, name), getattr(jback, name))
        _same(getattr(back, name), getattr(P, name))
    assert back.nnz == int(jback.nnz) == P.nnz
    assert back.shape == jback.shape == P.shape


# ---------------------------------------------------------------------------
# carrying a JAX SparseTensor across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fill", ["none", "rowptr", "all", "cleared"])
@pytest.mark.parametrize("case", list(CASES))
def test_sparse_tensor_from_jax(case, fill):
    _, J = _rand(**CASES[case])
    if fill == "rowptr":
        J.storage.rowptr()
        J.storage.colcount()
    elif fill in ("all", "cleared"):
        J.fill_cache_()
        if fill == "cleared":
            J.clear_cache_()
    T = tsp.sparse_tensor_from_jax(J, device="cpu")
    _same_tensor(T, J)
    assert T.storage.has_row() == J.storage.has_row()
    assert T.storage.has_rowptr() == J.storage.has_rowptr()
    x = np.random.default_rng(4).standard_normal((9, 2)).astype(np.float32)
    if T.dim() == 2:        # the carried-over tensor computes as the source
        np.testing.assert_allclose(_np(T @ torch.from_numpy(x)),
                                   _np(J @ jnp.asarray(x)),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# random stream and test grid
# ---------------------------------------------------------------------------
def test_seed():
    trandom.seed(3)
    a = torch.rand(4, generator=trandom.generator())
    trandom.seed(3)
    b = torch.rand(4, generator=trandom.generator())
    assert torch.equal(a, b)
    state = torch.random.get_rng_state()
    tsp.seed(4)
    torch.rand(2, generator=trandom.generator())
    assert torch.equal(torch.random.get_rng_state(), state)


def test_testing_grid():
    from paddle_sparse_tpu import testing as jtesting
    assert len(ttesting.dtypes) == len(jtesting.dtypes)
    assert [str(d)[6:] for d in ttesting.dtypes] == [
        np.dtype(d).name for d in jtesting.dtypes]
    assert ttesting.grad_dtypes == [torch.float32, torch.float64]
    assert ttesting.devices == ["cpu", "cuda"]
    t = ttesting.tensor([1, 2], torch.int32, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == [1, 2]
    ttesting.maybe_skip_testing(torch.float64, "cpu")      # no skip
    if not torch.cuda.is_available():
        with pytest.raises(pytest.skip.Exception):
            ttesting.maybe_skip_testing(torch.float32, "cuda")
