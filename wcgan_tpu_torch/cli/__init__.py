"""Command-line entry point of the port (``cli.run.main``)."""
