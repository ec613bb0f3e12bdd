"""Probes of the port: one-off measurements kept runnable, each the
counterpart of a probe in the JAX package's ``probes/``."""
