"""Configurations of the port: the paper's own 4x4 SoC (``vespa_soc``)."""
