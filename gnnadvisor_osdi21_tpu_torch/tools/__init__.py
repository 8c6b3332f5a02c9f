"""Checks and demos run from the command line."""
