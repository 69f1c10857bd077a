"""Multi-device encoders over a list of torch devices (mesh.py: the
row-band sharded encoder; exact.py: the exact band-pipelined encoder)."""
