"""Functional model cores of the port."""
