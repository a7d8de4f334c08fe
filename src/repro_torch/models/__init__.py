"""Models of the port: the decoder-only transformer LMs of the dense, moe,
ssm and hybrid families (layers, attention, moe, scan_utils, ssm, rglru,
transformer), at a config's published widths or ``reduced()``."""
