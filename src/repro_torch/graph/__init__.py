"""Graph inputs: seeded generators, edge streams and their owner router,
and exact triangle counts and t-hop neighborhood sizes (numpy only)."""
