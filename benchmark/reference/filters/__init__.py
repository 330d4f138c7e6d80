"""The reference of each filter that may follow the stabilizer in a chain,
one module a filter type (the `type` of the configuration's entry), each
with `apply(px, settings) -> px` on (C, H, W) planes in [0, 1]."""
