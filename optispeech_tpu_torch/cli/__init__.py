"""Command-line entry points: train, int8_ab."""
