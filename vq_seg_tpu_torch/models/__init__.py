"""Networks, encoders, modules and layers of the port (NCHW)."""
