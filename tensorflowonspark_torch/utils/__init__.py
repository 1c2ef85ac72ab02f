"""Utility helpers (env knobs, locks, paths)."""
