"""Graph generators, one module per traffic ``graph.kind``: ``draw(spec, device)``."""
