"""Multi-device execution on torch.distributed (counterpart of
illuminant_tpu/parallel/).

The decomposition is the JAX package's: every rank holds the (small) field,
the lights and the G-buffer replicated; the particle capacity is split
into one contiguous slot range a rank; the frame's pixel rows are split
into row bands of whole raster tiles. Particles reach the band owners their
splat touches through one `all_to_all_single` (`raster.py`), and the
exposure histogram is all-reduced, so every rank tonemaps its own band at
the same exposure. `mesh.py` builds the 1-D DeviceMesh and places the
frame's inputs on it.
"""
