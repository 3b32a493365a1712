"""Synthetic graph corpus and subgraph sampling."""
