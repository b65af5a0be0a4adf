"""Experiment plugins (the reference's ``mDT/experiments/`` layer)."""
