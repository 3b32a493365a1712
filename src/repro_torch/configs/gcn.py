"""GCN (paper §6.5): 5 layers, in/out 16, hidden ∈ {32,64,128}."""
GCN = {"model": "gcn", "n_layers": 5, "in_dim": 16, "out_dim": 16,
       "hidden": 64}
CONFIG = GCN
REDUCED = {**GCN, "n_layers": 3, "hidden": 32}
