"""Host-side helpers: shape bucketing and device choice."""
