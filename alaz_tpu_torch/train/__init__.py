"""Scoring entry points (training comes with a later slice)."""
