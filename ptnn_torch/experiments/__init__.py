"""Experiment drivers of the port (the entry points of ``ptnn.experiments``)."""
