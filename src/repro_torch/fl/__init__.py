"""Federated-learning round logic and the simulation engine of the port."""
