"""Serving: the HTTP daemon and the latency CLI."""
