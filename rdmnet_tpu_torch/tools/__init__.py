"""Measurement tools of the port, run by hand on a card (not on any model path)."""
