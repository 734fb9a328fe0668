"""Optimisers and the train step of the port (one process for now)."""
