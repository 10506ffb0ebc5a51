"""Host-side (numpy/C++) preprocessing: equilibration, static pivoting,
orderings, elimination trees, block symbolic factorization. A copy of
the JAX package's host modules, so both build the same plan."""
