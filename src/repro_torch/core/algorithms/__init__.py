"""Algorithm registry of the port."""
