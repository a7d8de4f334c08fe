"""Models of the port: the transformer stacks of all six families (dense,
moe, ssm, hybrid, vlm and audio; layers, attention, moe, scan_utils, ssm,
rglru, transformer), trained or served (prefill and decode with KV and
recurrent caches), at a config's published widths or ``reduced()``."""
