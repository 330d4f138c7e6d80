"""The reference of each warp filter the stabilizer may use, one module a
`warp_filter` setting, each with `remap(img, sample_map, fill) -> img`:
a backward warp of (C, H, W) planes through an absolute (2, H, W) map of
(y, x) source coordinates."""
