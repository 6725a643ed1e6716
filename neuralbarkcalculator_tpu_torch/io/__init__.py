"""Host IO: the ctypes binding to the native runtime, and the readers of
the JAX package's checkpoints (flax msgpack, orbax directories)."""
