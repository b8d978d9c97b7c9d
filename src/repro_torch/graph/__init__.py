"""Graph inputs: seeded generators and edge-block padding (numpy only)."""
