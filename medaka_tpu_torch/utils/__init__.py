"""Generic utilities (intervals)."""
