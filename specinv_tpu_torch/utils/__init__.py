"""Utilities: the iteration runner and the test corpus."""
