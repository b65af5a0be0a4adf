"""Training across ranks: the process group, the mesh and its layouts, per-rank input."""
