"""Host-side utilities of the port (phase timers)."""
