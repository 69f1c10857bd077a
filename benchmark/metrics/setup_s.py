"""setup_s: process start to the first measured request (loading,
building at a first run, making the inputs, warming every geometry)."""


def read(r):
    return r.setup_s
