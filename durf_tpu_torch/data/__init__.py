"""Host-side data for the port (numpy)."""
