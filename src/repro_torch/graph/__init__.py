"""Graph inputs: seeded generators, edge-block padding and exact triangle
counts (numpy only)."""
