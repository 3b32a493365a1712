"""Launchers of the LM side (so far: serving)."""
