"""Host IO: the ctypes binding to the native runtime."""
