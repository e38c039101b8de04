"""Launchers of the port: ``serve`` (batched continuous prefill+decode)."""
