"""Test utilities: synthetic dataset simulation for end-to-end validation."""
