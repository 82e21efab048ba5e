"""Logging and seeding helpers."""
