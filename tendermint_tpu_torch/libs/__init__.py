"""Process-wide helpers of the port (reference capability: libs/):
the clock seam, the retry backoff and the failpoint registry, trimmed to
what the device breakers and the mesh fabric use."""
