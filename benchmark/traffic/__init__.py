"""Traffic: ``<mix>.json`` holds a mix's parameters and names the generator
``<generator>.py`` that reads it."""
