"""Graph inputs: seeded generators (RMAT, Erdős–Rényi, Kronecker products
of named factors), edge streams and their owner router, and exact
triangle counts (Kronecker powers in O(m)) and t-hop neighborhood sizes
(numpy only)."""
