"""The systems under test, one module per architecture, named by a
configuration's `system` key: each builds the port's serving objects from a
configuration, a seed and the benchmark's weights."""
