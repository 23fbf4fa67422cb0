// The bfloat16 epilogue instances of dvt_conv_fused (csrc/int8_conv.cu,
// which holds the kernel, its design and what it replaces in the JAX
// package): the same source compiled with DVT_INT8_BF16 set, into a
// library of its own whose launcher is dvt_conv_fused_bf16, so that the
// bfloat16 and float32 instances compile in parallel.  kernels/_build.py
// hashes the included source with this one.
#define DVT_INT8_BF16 1
#include "int8_conv.cu"
