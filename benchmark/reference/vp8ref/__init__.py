"""A frozen copy of the lossy VP8 encoder in plain PyTorch and numpy:
the benchmark's reference for the bytes the measured package's encode
entry points must write (methods 0-4, kernel 4's skew-1 closed loop).

It is a copy of the plain versions of the measured package's device
program (ops/) and its Python host encoder and token writer
(lossy/encode.py, bitio/bool.py), with these changes:

  * the kernel wrappers are gone: phase 0/1 run the plain versions of
    kernels 1-3 (ops/phase1p.py, ops/i4.py) and phase 2 the skew-1 step
    loop (ops/planar.py), whichever device their tensors lie on; the
    step loop also returns each MB's reconstruction;
  * native/api.py reports no native library, so the host encoder and the
    token writer run their Python versions;
  * encoder.py is the numpy host YUV importer (gamma-corrected chroma
    averaging), in place of the measured package's native one;
  * no decoder, no trellis (methods 5-6): the files it writes are read
    back by the independent decoder beside it (../vp8dec.py).

It imports nothing of the measured package, and later changes to that
package do not reach it. Those plain versions, and this Python host
path, are held byte for byte against the JAX package by the measured
package's CPU tests.
"""

