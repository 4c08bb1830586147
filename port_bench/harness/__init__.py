"""The harness: discovery of cells, configurations, traffic mixes and
metric readers by name, the trace's reduction, peaks and rooflines, the
traffic's arithmetic and the comparison that decides ``correct``."""
