"""Adapters that build the port's objects for a configuration family
(``<family>.py``): its serving pipeline and its training step, through
the port's public entry points, with the benchmark's weights loaded."""
