"""Host preprocessing, the block pool, SpMV and the device kernels."""
