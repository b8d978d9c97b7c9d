"""Graph inputs: seeded generators, edge-block padding, and exact triangle
counts and t-hop neighborhood sizes (numpy only)."""
