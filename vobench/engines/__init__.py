"""Drivers of the port, one per kind of traffic mix."""
