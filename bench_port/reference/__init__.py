"""The benchmark's plain reference: PyTorch operations only, no kernel and
no module of the program. One module per model family (``gcn``, ``sage``),
found by the configuration's ``model`` key; ``sparse`` holds the blocked
sparse products, ``train`` the SGD steps."""
