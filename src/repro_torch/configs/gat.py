"""GAT (attention GNN): dot-product edge attention via the PCSR
SDDMM→softmax→SpMM pair; layer count/dims match the GCN setup.

``heads`` batches the attention head dimension through the kernels — one
head-tiled launch per operator on the card — hidden layers concatenate
heads, the output layer averages them (``hidden`` must divide by
``heads``)."""
GAT = {"model": "gat", "n_layers": 3, "in_dim": 16, "out_dim": 16,
       "hidden": 64, "heads": 1}
CONFIG = GAT
REDUCED = {**GAT, "hidden": 32}
# multi-head variant: 4 heads of 16 channels concatenated per hidden layer
GAT_MH = {**GAT, "heads": 4}
