"""The correctness checks, one module per architecture, named by a
configuration's `check` key (see `harness.run_cell`)."""
