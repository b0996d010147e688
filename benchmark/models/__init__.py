"""Seeded inputs of the configurations: weights, bodies, mean parameters."""
