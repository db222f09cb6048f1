"""Receivers of the port."""
