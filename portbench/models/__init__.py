"""Adapters that drive the port, one per model kind (a configuration's ``model``)."""
