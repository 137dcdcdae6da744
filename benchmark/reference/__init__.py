"""The plain reference of the benchmark: the standard library's ``zlib``
and a small DEFLATE reader in Python and NumPy (RFC 1950/1951).  It imports
nothing of the program under test, of its JAX original, or of JAX."""
