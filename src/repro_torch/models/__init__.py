"""Models of the port: the dense decoder-only transformer LM (layers,
attention, transformer), at a config's published widths or ``reduced()``."""
