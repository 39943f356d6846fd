"""Model definitions and the decode step (port of ``repro.models``)."""
