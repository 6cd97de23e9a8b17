"""Command-line tools of the port (the ``server``, ``checkpoint`` and
``dataset`` groups)."""
