"""Host-side telemetry of the port (metrics registry and event ring)."""
