"""Host-side (numpy) data path: scene and mesh readers, manifest datasets,
batch assembly with triangle subdivision, and the prefetching loader."""
