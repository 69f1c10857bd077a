"""The benchmark's plain reference: what each measured entry point must
produce, computed without the measured package (vp8ref is a frozen copy
of its plain PyTorch and Python versions; see vp8ref/__init__.py)."""
