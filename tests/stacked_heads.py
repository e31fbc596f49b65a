"""The per-head SpMM as GAT's heads ran before they were one call: one
``adj.with_value(value[:, k]).spmm`` a head on the head's block of x's
columns, the outputs stacked. The tests hold ``PaddedCOO.spmm(x,
value=...)`` (``ops/spmm.py::_HeadsSpmm``) to it."""
import torch


def stacked_heads(adj, value, x):
    """``adj.spmm(x, value=value)`` for an (E, H) ``value``, head by head:
    x's trailing dims flattened into H blocks of columns, the output of
    x's trailing shape."""
    xh = x.reshape(x.shape[0], value.shape[1], -1)
    out = torch.stack([adj.with_value(value[:, k]).spmm(xh[:, k])
                       for k in range(xh.shape[1])], dim=1)
    return out.reshape((out.shape[0],) + tuple(x.shape[1:]))


def stacked_spmm(spmm):
    """``PaddedCOO.spmm`` (pass it, to patch it) with a ``value=`` call run
    by :func:`stacked_heads`; any other call ``spmm`` itself."""
    def stacked(adj, x, reduce="sum", backend="auto", value=None):
        if value is None:
            return spmm(adj, x, reduce, backend)
        return stacked_heads(adj, value, x)
    return stacked
