"""Generators: each reads the parameters of a traffic file
(``traffic/<name>.json`` names its generator) and makes a run's inputs
from its seed."""
