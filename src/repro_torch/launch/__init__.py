"""Launchers: the determinant serving queue and its CLI."""
