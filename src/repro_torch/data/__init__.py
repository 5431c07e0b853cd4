"""Seeded synthetic datasets."""
