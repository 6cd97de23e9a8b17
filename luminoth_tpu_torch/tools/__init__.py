"""Command-line tools of the port (the ``server`` and ``checkpoint`` groups)."""
