"""Graph generators, one file each, named by a traffic file's
``generator``.  Each module defines ``generate(seed, **params)`` returning
``(indptr, indices, n)``: a symmetric, binary adjacency without self
loops in canonical CSR (rows in order, columns sorted, no duplicates),
int64 arrays."""
