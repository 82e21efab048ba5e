"""Command-line entry points: train, evaluate, generate."""
