"""Stage timers, device selection and the native builds."""
