"""Replica exchange across the chain axis."""
