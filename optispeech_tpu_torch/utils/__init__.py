"""Host-side helpers: shape bucketing, device choice, config files, logging."""
