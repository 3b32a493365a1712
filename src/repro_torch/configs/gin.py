"""GIN (paper §6.5): 5 layers, in/out 16, hidden ∈ {32,64,128}."""
GIN = {"model": "gin", "n_layers": 5, "in_dim": 16, "out_dim": 16,
       "hidden": 64}
CONFIG = GIN
REDUCED = {**GIN, "n_layers": 3, "hidden": 32}
