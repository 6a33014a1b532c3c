"""Command-line tools of the port (ports of the repository's ``tools/``)."""
