"""Host-side I/O of the port (numpy / PIL, no torch)."""
