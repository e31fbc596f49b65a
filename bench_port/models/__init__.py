"""One module per model family, found by the configuration's ``model``
key: its parameters' names and shapes, how the program builds it, and the
work (sparse products, GEMM operations) of its equations."""
