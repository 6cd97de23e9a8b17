"""Command-line tools of the port (the ``server`` group)."""
