"""Process-wide helpers of the port (reference capability: libs/):
the clock seam, the retry backoff and the failpoint registry, trimmed to
what the device breakers and the mesh fabric use, the bit arrays a
block's part set keeps, the overload controller, the key-value store
the node's stores run on (db.py) and RFC3339 times (timeenc.py)."""
