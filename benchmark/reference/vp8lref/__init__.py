"""A frozen copy of the measured package's VP8L (lossless) encoder: the
benchmark's reference for the bytes that `encode(img, lossless=True)`
must write.

It copies the package's Python top level, transforms, palette and bit
writer (encode.py, near_lossless.py, bitio.py), with the plain numpy
predictor search in place of the native and device searches, and the
package's C++ entropy coder (vp8l_enc.cc: LZ77, colour cache, Huffman
codes, emission) and cross-color search (vp8l_cross_color.cc), built by
this reference's own g++ step (native.py) in its own build directory.

That C++ departs on purpose from the lossy reference's rule of no native
library (../vp8ref): no plain version writes these bytes. The package's
numpy entropy coder writes other, larger streams, so the C++ is what
defines the bytes, in both packages. What guards losslessness
independently of any copy is the read-back: every checked file is
decoded by ../vp8ldec.py, written from RFC 9649, and compared with the
image's pixels.

It imports nothing of the measured package, and later changes to that
package do not reach it.
"""
