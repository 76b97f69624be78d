"""Data loading and host-side signal processing (numpy)."""
