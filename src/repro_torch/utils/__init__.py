"""Host-side helpers: nested-dict trees, device selection, telemetry."""
