"""Runnable examples of the port (ports of the repository's ``examples/``)."""
