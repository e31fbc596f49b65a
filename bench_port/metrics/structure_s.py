"""structure_s: seconds of the program's structure set-up, a span of the
harness on the host's clock with a synchronize on both sides:
``gcn_normalize`` where the model normalizes, ``PaddedCOO.rowptr()`` and
``row_split()``, and to train the CSC view ``structure()``. Moves
``setup_s``.
"""


def read(ctx):
    return ctx.spans.get("structure_s")
