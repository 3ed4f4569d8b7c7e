"""Drivers: one entry point of the port each (``<driver>.py``), with a
``Bench`` class whose ``setup``, ``window`` and ``check`` a run calls in
turn."""
