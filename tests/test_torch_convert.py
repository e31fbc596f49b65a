"""Port parity: paddle_sparse_tpu_torch.ops.convert against the JAX
paddle_sparse_tpu.ops.convert on the same numpy inputs (exact equality)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import convert as jconv
from paddle_sparse_tpu_torch.ops import convert as tconv


def _sorted_rows(M, nnz, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, max(M, 1), nnz)).astype(np.int32)


def _ptr(degrees, base=0):
    return (base + np.concatenate([[0], np.cumsum(degrees)])).astype(np.int32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("M,nnz", [(0, 0), (10, 0), (5, 20), (100, 37),
                                   (64, 1000)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_ind2ptr(M, nnz, dtype):
    row = _sorted_rows(M, nnz, seed=M + nnz).astype(dtype)
    got = tconv.ind2ptr(torch.from_numpy(row), M)
    assert got.dtype == torch.from_numpy(row).dtype
    assert got.shape == (M + 1,)
    _eq(got, jconv.ind2ptr(jnp.asarray(row), M))


# pointers with empty segments, trailing empty segments, a single segment,
# and no segment at all
PTRS = {
    "empty_rows": [0, 3, 0, 0, 5, 1, 0],
    "trailing_empty": [2, 2, 0, 0],
    "leading_empty": [0, 0, 4, 1],
    "single": [7],
    "all_empty": [0, 0, 0],
    "no_rows": [],
}


@pytest.mark.parametrize("name", sorted(PTRS))
@pytest.mark.parametrize("base", [0, 7])   # 7: non-canonical, gets rebased
def test_ptr2ind(name, base):
    ptr = _ptr(PTRS[name], base)
    E = int(ptr[-1] - ptr[0])
    got = tconv.ptr2ind(torch.from_numpy(ptr), E)
    assert got.dtype == torch.int32 and got.shape == (E,)
    _eq(got, jconv.ptr2ind(jnp.asarray(ptr), E))


@pytest.mark.parametrize("name", sorted(PTRS))
@pytest.mark.parametrize("base", [0, 7])
@pytest.mark.parametrize("extra", [0, 5])
def test_ptr2ind_capped(name, base, extra):
    ptr = _ptr(PTRS[name], base)
    cap = int(ptr[-1] - ptr[0]) + extra
    got = tconv.ptr2ind_capped(torch.from_numpy(ptr), cap)
    assert got.shape == (cap,)
    _eq(got, jconv.ptr2ind_capped(jnp.asarray(ptr), cap))
    # padding positions map to the one-past-last row M
    assert (got[cap - extra:] == len(ptr) - 1).all()


def test_ptr2ind_roundtrip_random():
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 6, 500)
    deg[rng.integers(0, 500, 100)] = 0
    ptr = _ptr(deg)
    E = int(ptr[-1])
    row = tconv.ptr2ind(torch.from_numpy(ptr), E)
    _eq(row, jconv.ptr2ind(jnp.asarray(ptr), E))
    _eq(tconv.ind2ptr(row, 500), ptr)
