"""Host-side data pipeline: trees, preprocessing, collation, synthetic data."""
