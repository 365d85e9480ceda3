"""Batched device PSI engine (port of ``repro.psi``)."""
