"""Execution strategies and step functions (one device so far)."""
