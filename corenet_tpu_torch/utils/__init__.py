"""Small host-side helpers: rounding and tiling, local + gs:// file I/O."""
