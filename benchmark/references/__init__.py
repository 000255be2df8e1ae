"""Plain float32 references, one module per architecture, named by a
configuration's `reference` key."""
