"""HatefulDiscussions experiment: the registered dataset factory and the
processed-graph writers (reference: mDT/experiments/hateful_discussions/)."""
