"""Traffic: each mix is a data file ``<traffic>.json`` of parameters that
names the generator (``<generator>.py`` here) that reads it."""
