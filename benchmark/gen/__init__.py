"""Frozen, seeded, vectorised input generators of the benchmark."""
