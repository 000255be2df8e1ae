"""The traffic runners, one module per traffic `kind`, each with a
`Runner(traffic, system, seed, seconds)` class (see `generator.py`)."""
