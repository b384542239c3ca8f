"""Launchers: the determinant serving queue and its CLI, the LM serve
and train drivers and their step factories."""
