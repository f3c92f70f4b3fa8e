"""Copied configuration and table modules (see the package docstring)."""
