"""Hand-written kernels for the hot paths.

The reference's drjit-core emits fused CUDA/LLVM kernels for the render
loop (SURVEY.md §2.2). Here XLA compiles the render loop from plain JAX,
and this package holds the one operation written by hand:

* traverse — skip-link BVH traversal, one ray per thread, compiled from
  native/bvh_traverse.cu and called through the XLA FFI.
"""
