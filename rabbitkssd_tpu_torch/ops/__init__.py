"""Device compute for the port: window hash, keep-test kernel, counting."""
