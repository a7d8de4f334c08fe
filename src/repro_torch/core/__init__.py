"""Core layers of the port: chunking, channel, scheduling, compression and
algorithms."""
