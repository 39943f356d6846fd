"""Serving engine over the hybrid plane."""
