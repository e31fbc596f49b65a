"""One module per way of driving the program, found by a traffic mix's
``driver`` key: ``fullbatch`` (full-batch GNN training and inference)."""
