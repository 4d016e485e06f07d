"""Command-line tools that drive the port on a GPU (run with ``python3 -m``)."""
