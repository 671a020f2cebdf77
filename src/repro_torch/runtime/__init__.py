"""Host-side serving runtime: request lifecycle and watchdog (numpy only)."""
