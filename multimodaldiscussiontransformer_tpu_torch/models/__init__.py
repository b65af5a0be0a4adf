"""Model modules: towers, fusion, graph encoder, the full mDT."""
