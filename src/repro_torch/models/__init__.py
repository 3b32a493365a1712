"""GNN models of the PyTorch port."""
