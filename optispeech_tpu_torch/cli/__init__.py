"""Command-line entry points: train."""
