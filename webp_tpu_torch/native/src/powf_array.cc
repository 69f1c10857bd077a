// Elementwise single-precision power with the C library's powf, for the
// CPU form of the device sharp-YUV conversion (ops/sharpyuv.py).
//
// The reference evaluates its BT.709 transfer curves with float32 `pow`,
// which on the CPU is the C library's powf bit for bit; PyTorch's CPU
// pow is not (it is one ulp off on some inputs), and a one-ulp difference
// can flip an output sample. This file is built without
// -ffast-math, so the loop stays scalar powf calls.
#include <math.h>

extern "C" void powf_array(const float* x, float e, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = powf(x[i], e);
}
