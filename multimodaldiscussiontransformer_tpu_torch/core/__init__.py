"""Config dataclasses."""
